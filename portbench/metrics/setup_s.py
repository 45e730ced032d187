"""setup_s: seconds from the command's first line to the start of the window
(imports, card, build or cache, inputs, warm-up).
"""


def read(run):
    return run.setup_s
