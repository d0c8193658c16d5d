"""Training-curve plotter (ref: python/paddle/utils/plot.py). The book
chapters call Ploter.append/plot each pass; plotting degrades to a
text log when matplotlib/display is unavailable (same spirit as the
reference's DISABLE_PLOT env check)."""
import os

__all__ = ["PlotData", "Ploter"]


class PlotData:
    def __init__(self):
        self.reset()

    def append(self, step, value):
        self.step.append(step)
        self.value.append(value)

    def reset(self):
        self.step = []
        self.value = []


class Ploter:
    def __init__(self, *args):
        self.__args__ = args
        self.__plot_data__ = {title: PlotData() for title in args}
        self.__disable_plot__ = os.environ.get("DISABLE_PLOT", "")

    def __plot_is_disabled__(self):
        return self.__disable_plot__ == "True"

    def append(self, title, step, value):
        if title not in self.__plot_data__:
            raise ValueError("no title %r in Ploter(%s)"
                             % (title, ", ".join(self.__args__)))
        self.__plot_data__[title].append(step, value)

    def _log_text(self):
        for title, data in self.__plot_data__.items():
            if data.step:
                print("%s: step %s value %s"
                      % (title, data.step[-1], data.value[-1]))

    def plot(self, path=None):
        if self.__plot_is_disabled__():
            return
        if path is None:
            # no file target and no interactive display here — log the
            # latest values instead of silently drawing an unseen figure
            self._log_text()
            return
        try:
            import matplotlib.pyplot as plt
        except Exception:  # noqa: BLE001 — plotless hosts log instead
            self._log_text()
            return
        # draw on an explicit figure: never touch the caller's backend,
        # current figure, or other open figures
        fig, ax = plt.subplots()
        titles = []
        for title, data in self.__plot_data__.items():
            if len(data.step) > 0:
                ax.plot(data.step, data.value, label=title)
                titles.append(title)
        ax.legend(titles, loc="upper left")
        fig.savefig(path)
        plt.close(fig)

    def reset(self):
        for data in self.__plot_data__.values():
            data.reset()
