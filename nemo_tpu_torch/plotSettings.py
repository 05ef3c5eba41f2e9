"""Shared matplotlib styling (parity with ``nemo/plotSettings.py``)."""


def update_rcParams(dict_extra=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.rcParams.update({
        "font.family": "sans-serif",
        "font.size": 13,
        "axes.labelsize": 15,
        "axes.titlesize": 15,
        "xtick.labelsize": 13,
        "ytick.labelsize": 13,
        "xtick.direction": "in",
        "ytick.direction": "in",
        "xtick.top": True,
        "ytick.right": True,
        "legend.fontsize": 12,
        "figure.dpi": 100,
        "savefig.dpi": 150,
    })
    if dict_extra is not None:
        plt.rcParams.update(dict_extra)
