"""columns_per_s: the columns of every call of the window over its wall
time, from the first call's start to the last call's synchronise."""


def read(w):
    return len(w.calls) * w.columns / (w.calls[-1][1] - w.calls[0][0])
