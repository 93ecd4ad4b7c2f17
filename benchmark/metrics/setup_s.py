"""setup_s: seconds from the process's start to the window's: imports,
reaching the card, the kernel library's build or load, the inputs and the
warm-up."""


def read(run):
    return run.setup_s
