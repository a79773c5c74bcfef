#!/usr/bin/env python
"""Benchmark harness of the PyTorch/CUDA port, the twin of bench.py; the
harness itself is raytracinggrff_tpu_torch/harness.py.

    python bench_torch.py [--pipeline]        # on a card
    python bench_torch.py --device cpu --n-pix 4 --n-steps 40 --grid-n 16

Prints one JSON line: ray-steps/sec/chip, or with --pipeline
pipeline-s-per-frequency.
"""

from raytracinggrff_tpu_torch.harness import main

if __name__ == "__main__":
    main()
