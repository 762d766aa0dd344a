"""setup_s: from the start of the process to the first timed round:
imports, the CUDA context, the kernel library's build (first run in a
checkout) and load, the weights drawn on the card and the first rounds
that warm every shape; less the seconds the correctness check spends on
its own copies of the parameters."""


def read(run):
    return run.setup_s
