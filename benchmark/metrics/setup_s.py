"""``setup_s``: seconds from the process's start to the first timed call
(imports, kernel loads or builds, the model and weights on the card, the
inputs, the warm-up calls and captures; a training cell's checked
steps)."""


def read(run, name):
    return run["setup_s"]
