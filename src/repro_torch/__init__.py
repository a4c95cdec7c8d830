"""PyTorch/CUDA port of the JAX package ``repro``'s model zoo.

It imports torch and numpy, never JAX and nothing of ``repro``: what it needs
from there it keeps as its own copy, under the same module names. It serves
the dense decoder LM (tinyllama-1.1b) and the Mamba-2 SSM (mamba2-370m)
through the hand-written CUDA kernels in ``repro_torch.kernels``
(``launch/serve.py``), and trains the dense LM with AdamW, checkpoints and
the synthetic data pipeline (``launch/train.py``), its attention forward and
backward on hand-written kernels.
"""
