"""setup_s: seconds from process start to the first timed unit: CUDA
init, the kernel build or load, the seeded MAS model written, the
program's set-up and the warm-up unit (host clock)."""


def read(run):
    return run.setup_s
