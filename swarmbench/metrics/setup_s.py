"""setup_s: process start to the end of the warm-up run: interpreter,
imports, CUDA context, the corpus from the seed, the warm-up run."""


def read(ctx):
    return ctx["setup_s"]
