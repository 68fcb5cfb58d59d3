"""setup_s: from the process's start (the kernel's record of it, so the
interpreter and the imports count) to the first timed frame: inputs,
kernel build or load, the graph's launch, rectification maps and the
warm-up frames."""


def read(run):
    return run.setup_s
