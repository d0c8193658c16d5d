"""slim.graph.executor (ref contrib/slim/graph/executor.py).

Port of paddle_tpu/fluid/contrib/slim/graph/executor.py:
SlimGraphExecutor runs a GraphWrapper's program through the port's
Executor (one ``run``; the reference re-dispatches per op)."""
import numpy as np

from ....executor import Executor

__all__ = ["SlimGraphExecutor"]


class SlimGraphExecutor(object):
    def __init__(self, place):
        self.exe = Executor(place)
        self.place = place

    def run(self, graph, scope, data=None):
        """Run the graph's program; ``data`` is a feed dict or a list of
        batches matching graph.in_nodes (ref executor.py:35)."""
        feed = None
        if data is not None:
            if isinstance(data, dict):
                feed = data
            else:
                feed = {}
                names = list(graph.in_nodes.values())
                for name, value in zip(names, data):
                    feed[name] = np.asarray(value)
        fetch_list = [graph.var(n).name if hasattr(graph.var(n), "name")
                      else n for n in graph.out_nodes.values()]
        return self.exe.run(graph.program, scope=scope, feed=feed,
                            fetch_list=fetch_list)
