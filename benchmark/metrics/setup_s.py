"""setup_s: seconds from the start of the process to the end of the
warm-up (imports, the build of the kernels on a checkout's first run, the
model, the seeded inputs and weights, the first units)."""


def read(ctx):
    return ctx["setup_s"]
