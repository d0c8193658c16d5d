"""LightNAS search strategy
(ref contrib/slim/nas/light_nas_strategy.py:36 LightNASStrategy).

The reference couples three pieces: a socket ControllerServer wrapping
the SA controller (one per host group, elected via a flock'd pid file),
SearchAgents that report rewards and fetch the next candidate, and this
Strategy driving the Compressor epoch loop: propose tokens ->
create_net -> respect the FLOPs/latency budget -> (re)train ->
evaluate -> reward -> update controller. None of that needs pserver
machinery; candidates are evaluated through the port's Executor here,
and the controller traffic is host-side TCP exactly like the reference.
Port of paddle_tpu/fluid/contrib/slim/nas/light_nas_strategy.py.

Adaptation to this build (documented in SearchSpace): create_net's
programs must use fluid.data feed names equal to the Compressor's feed
display names, and the *_metrics returns are [(display, var_name)]
lists — the strategy swaps the context's train/eval/optimize
GraphWrappers wholesale each proposal.
"""
import logging
import os
import socket

from ..core.strategy import Strategy
from ..graph import GraphWrapper
from ....log_helper import get_logger
from .controller_server import ControllerServer
from .lock import lock, unlock
from .search_agent import SearchAgent

__all__ = ["LightNASStrategy"]

_logger = get_logger(
    __name__, logging.INFO,
    fmt="LightNASStrategy-%(asctime)s-%(levelname)s: %(message)s")

_SOCKET_FILE = "./slim_LightNASStrategy_controller_server.socket"


class LightNASStrategy(Strategy):
    def __init__(self, controller=None, end_epoch=1000,
                 target_flops=629145600, target_latency=0,
                 retrain_epoch=1, metric_name="top1_acc", server_ip=None,
                 server_port=0, is_server=True, max_client_num=100,
                 search_steps=None, key="light-nas"):
        """Args mirror the reference (light_nas_strategy.py:41). The one
        default change: is_server=True, because the common deployment is
        single-host (the reference expects an explicit
        server election across a pserver fleet)."""
        super().__init__(start_epoch=0, end_epoch=end_epoch)
        self._max_flops = target_flops
        self._max_latency = target_latency
        self._metric_name = metric_name
        self._controller = controller
        self._retrain_epoch = retrain_epoch
        self._server_ip = server_ip or self._get_host_ip()
        self._server_port = server_port
        self._is_server = is_server
        self._search_steps = search_steps
        self._max_client_num = max_client_num
        self._max_try_times = 100
        self._key = key
        self._server = None

    @staticmethod
    def _get_host_ip():
        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return "127.0.0.1"

    def __getstate__(self):
        """Sockets can't be pickled (checkpointing)."""
        return {k: v for k, v in self.__dict__.items()
                if k not in ("_search_agent", "_server")}

    # ------------------------------------------------------------------
    def on_compression_begin(self, context):
        if context.search_space is None:
            raise ValueError(
                "LightNASStrategy needs Compressor(search_space=...) — "
                "a slim.nas.SearchSpace with init_tokens/range_table/"
                "create_net")
        self._current_tokens = context.search_space.init_tokens()
        self._controller.reset(context.search_space.range_table(),
                               self._current_tokens, None)
        if self._is_server:
            # one server per host: first strategy to grab the flock'd
            # pid file starts it, others read its port and reuse (ref
            # strategy:101 — which stores only the thread id, so reuse
            # can never discover the port; we store "tid<TAB>port").
            # A stale file from a crashed run parses but refuses
            # connections — surfaced by the agent's clear no-reply /
            # refused errors, cleared by deleting the file.
            open(_SOCKET_FILE, "a").close()
            with open(_SOCKET_FILE, "r+") as socket_file:
                lock(socket_file)
                try:
                    line = socket_file.readline().strip()
                    parts = line.split("\t")
                    if line and len(parts) == 2 and parts[1].isdigit():
                        self._server_port = int(parts[1])
                        _logger.info("reusing controller server on "
                                     "port %d" % self._server_port)
                    else:
                        _logger.info("start controller server...")
                        self._server = ControllerServer(
                            controller=self._controller,
                            address=(self._server_ip, self._server_port),
                            max_client_num=self._max_client_num,
                            search_steps=self._search_steps,
                            key=self._key)
                        tid = self._server.start()
                        self._server_port = self._server.port()
                        socket_file.seek(0)
                        socket_file.truncate()
                        socket_file.write(
                            "%s\t%d" % (tid, self._server_port))
                finally:
                    unlock(socket_file)
        _logger.info("server: %s:%s" % (self._server_ip,
                                        self._server_port))
        self._search_agent = SearchAgent(
            self._server_ip, self._server_port, key=self._key)

    def _propose_next(self, min_tokens):
        """Next candidate under the budget-retry loop. The reference
        consults the local controller directly here (strategy:157) —
        valid only in the process that actually RUNS the server (a
        reusing process's local controller instance never sees updates;
        it must ask over the wire)."""
        if self._controller is not None and self._server is not None:
            return self._controller.next_tokens(min_tokens)
        return self._search_agent.next_tokens()

    def on_epoch_begin(self, context):
        if not (self.start_epoch <= context.epoch_id <= self.end_epoch
                and (self._retrain_epoch == 0
                     or (context.epoch_id - self.start_epoch)
                     % self._retrain_epoch == 0)):
            return
        _logger.info("light nas strategy on_epoch_begin")
        min_flops = -1
        min_tokens = None
        for _ in range(self._max_try_times):
            (startup_p, train_p, test_p, train_metrics, test_metrics,
             train_reader, test_reader) = \
                context.search_space.create_net(self._current_tokens)
            # contract (SearchSpace docstring): created nets name their
            # fluid.data vars after the Compressor's feed DISPLAY names
            eval_graph = GraphWrapper(
                test_p,
                in_nodes=[(d, d) for d in
                          (context.eval_graph.in_nodes
                           if context.eval_graph is not None else {})],
                out_nodes=test_metrics)
            flops = eval_graph.flops()
            if min_flops == -1 or flops < min_flops:
                min_flops = flops
                min_tokens = self._current_tokens[:]
            latency = 0
            if self._max_latency > 0:
                latency = context.search_space.get_model_latency(test_p)
                _logger.info("try %s with latency %s flops %s"
                             % (self._current_tokens, latency, flops))
            else:
                _logger.info("try %s with flops %s"
                             % (self._current_tokens, flops))
            if flops > self._max_flops or (self._max_latency > 0
                                           and latency
                                           > self._max_latency):
                self._current_tokens = self._propose_next(min_tokens)
            else:
                break
        else:
            raise RuntimeError(
                "LightNAS: no candidate satisfied the budget in %d "
                "tries (target_flops=%s)"
                % (self._max_try_times, self._max_flops))

        # adopt the candidate: swap the context's graphs + readers
        self._adopted_test_p = test_p   # reused by the latency reward
        feed_names = [
            (d, d) for d in (context.train_graph.in_nodes
                             if context.train_graph is not None else {})
        ]
        context.train_reader = train_reader
        context.eval_reader = test_reader
        context.eval_graph = eval_graph
        context.train_graph = GraphWrapper(
            train_p, in_nodes=feed_names, out_nodes=train_metrics)
        # train_p from create_net already carries backward+optimizer
        context.optimize_graph = context.train_graph

        from ....executor import Executor

        Executor(context.place).run(startup_p, scope=context.scope)
        context.skip_training = (self._retrain_epoch == 0)

    def on_epoch_end(self, context):
        if not (self.start_epoch <= context.epoch_id < self.end_epoch
                and (self._retrain_epoch == 0
                     or (context.epoch_id - self.start_epoch + 1)
                     % self._retrain_epoch == 0)):
            return
        results = context.eval_results.get(self._metric_name)
        if context.eval_results and results is None:
            raise ValueError(
                "LightNAS reward metric %r not in eval results %s — "
                "name one of the eval fetch display names"
                % (self._metric_name, sorted(context.eval_results)))
        # only reward the candidate with an eval that actually ran THIS
        # epoch (compressor eval_epoch > 1 skips epochs; crediting a
        # stale number to a new candidate would corrupt the SA signal)
        n_seen = getattr(self, "_evals_consumed", 0)
        if not results or len(results) == n_seen:
            _logger.info(
                "no fresh eval at epoch %d (eval_epoch gating?); "
                "skipping controller update" % context.epoch_id)
            return
        self._evals_consumed = len(results)
        reward = float(results[-1])
        flops = context.eval_graph.flops()
        if flops > self._max_flops:
            reward = 0.0
        if self._max_latency > 0:
            # the adopted candidate's test program was built in
            # on_epoch_begin — no need to create_net a second time
            # (the reference rebuilds here, ref strategy:184)
            test_p = getattr(self, "_adopted_test_p", None)
            if test_p is None:
                test_p = context.search_space.create_net(
                    self._current_tokens)[2]
            latency = context.search_space.get_model_latency(test_p)
            if latency > self._max_latency:
                reward = 0.0
            _logger.info("reward: %s; latency: %s; flops: %s; tokens: %s"
                         % (reward, latency, flops,
                            self._current_tokens))
        else:
            _logger.info("reward: %s; flops: %s; tokens: %s"
                         % (reward, flops, self._current_tokens))
        self._current_tokens = self._search_agent.update(
            self._current_tokens, reward)

    def on_compression_end(self, context):
        if self._server is not None:
            self._server.close()
            try:
                os.unlink(_SOCKET_FILE)
            except OSError:
                pass
