"""Plot training/testing curves from paddle-style logs
(ref: python/paddle/utils/plotcurve.py — same CLI and log grammar).

Log lines look like ``... Batch=200 AvgCost=0.5 ... Eval: AvgCost=0.6``;
``plot_paddle_curve`` extracts each requested key's train ("pass"-line)
and test ("Eval"-line) series and renders them with matplotlib.
"""
import re
import sys

__all__ = ["plot_paddle_curve", "main"]


def _series(keys, lines):
    train = {k: [] for k in keys}
    test = {k: [] for k in keys}
    for line in lines:
        is_test = "Eval" in line or "Test" in line
        for k in keys:
            for m in re.finditer(r"%s[=:]\s*([0-9.eE+-]+)" % re.escape(k),
                                 line):
                try:
                    (test if is_test else train)[k].append(
                        float(m.group(1)))
                except ValueError:
                    pass
    return train, test


def plot_paddle_curve(keys, inputfile, outputfile, format="png",
                      show_fig=False):
    """Extract ``keys`` from the log stream and save the curve figure
    (ref plotcurve.py:62)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if not keys:
        keys = ["AvgCost"]
    lines = inputfile.readlines() if hasattr(inputfile, "readlines") \
        else list(inputfile)
    train, test = _series(keys, lines)
    if not any(train[k] or test[k] for k in keys):
        sys.stderr.write("No data to plot. Exiting!\n")
        return
    plt.figure()
    for k in keys:
        if train[k]:
            plt.plot(range(len(train[k])), train[k], label="train-" + k)
        if test[k]:
            plt.plot(range(len(test[k])), test[k], "--",
                     label="test-" + k)
    plt.xlabel("pass")
    plt.ylabel(", ".join(keys))
    plt.legend()
    plt.savefig(outputfile, format=format)
    if show_fig:
        plt.show()
    plt.close()


def main(argv):
    import argparse

    parser = argparse.ArgumentParser(
        description="Plot training and testing curves from paddle log "
                    "file.")
    parser.add_argument("key", nargs="*", help="keys of scores to plot, "
                        "the default will be AvgCost")
    parser.add_argument("-i", "--input", default="-",
                        help="input filename of paddle log")
    parser.add_argument("-o", "--output", required=True,
                        help="output filename of figure")
    parser.add_argument("--format", default="png",
                        help="figure format(png|pdf|ps|eps|svg)")
    args = parser.parse_args(argv)
    fin = sys.stdin if args.input in ("-", "") else open(args.input)
    try:
        plot_paddle_curve(args.key or ["AvgCost"], fin, args.output,
                          args.format)
    finally:
        if fin is not sys.stdin:
            fin.close()


if __name__ == "__main__":
    main(sys.argv[1:])
