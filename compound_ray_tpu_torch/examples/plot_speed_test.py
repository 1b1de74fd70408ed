"""Plot speed-test result files (python-examples/speed-test/plotter.py) on
the port (examples/plot_speed_test.py).

Reads the `*-frame-rendertime-averages-*.txt` files that speed_test writes
(or the reference's speedTest.py: the same format, one mean frame time in
ms per line) and plots frame time and the rays/s derived from it.  Only
the plot needs matplotlib; read_results parses the files without it.

    python -m compound_ray_tpu_torch.examples.plot_speed_test *.txt
"""

import argparse
import os

import numpy as np


def read_results(files, ommatidia=1000, samples=None):
    """[(label, samples per line, frame ms, ommatidial rays/s)] per file."""
    out = []
    for path in files:
        times = np.atleast_1d(np.loadtxt(path))
        xs = (np.asarray(samples) if samples
              else np.arange(1, len(times) + 1))
        label = os.path.basename(path).split("-frame-rendertime")[0]
        out.append((label, xs, times, ommatidia * xs / (times / 1000.0)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("files", nargs="+", help="result .txt files")
    ap.add_argument("-n", "--ommatidia", type=int, default=1000)
    ap.add_argument("-s", "--samples", type=int, nargs="+", default=None,
                    help="sample counts per line (default: 1..len)")
    ap.add_argument("-o", "--output", default="speed-test-plot.png")
    args = ap.parse_args(argv)
    results = read_results(args.files, args.ommatidia, args.samples)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for label, xs, times, rays in results:
        ax1.plot(xs, times, marker=".", label=label)
        ax2.plot(xs, rays, marker=".", label=label)
    ax1.set(xlabel="samples per ommatidium", ylabel="frame time (ms)",
            title="Frame render time")
    ax2.set(xlabel="samples per ommatidium", ylabel="ommatidial rays / s",
            title="Throughput")
    ax2.set_yscale("log")
    for ax in (ax1, ax2):
        ax.grid()
        ax.legend()
    fig.tight_layout()
    fig.savefig(args.output, dpi=120)
    print(f"Wrote {args.output}")


if __name__ == "__main__":
    main()
