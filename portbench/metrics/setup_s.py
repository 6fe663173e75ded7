"""setup_s: from the process's start to the window's: imports, the
kernel library (built on a checkout's first run), the lookup tables,
setup_radiation, the input pool on the card and the warm-up calls."""


def read(w):
    return w.setup_s
