"""Hand-written CUDA kernels of the port, one per Pallas TPU kernel of the
JAX package's ``repro.kernels`` that the port's paths run.

* ``flash_attention``  — blocked online-softmax attention (prefill), causal
  and GQA-native; ``csrc/flash_attention.cu``.
* ``decode_attention`` — one new token against the KV cache, masked to a
  device-side length; ``csrc/decode_attention.cu``.
* ``ssd``              — the Mamba-2 SSD chunked scan (prefill), carrying
  an fp32 state from chunk to chunk; ``csrc/ssd.cu``.

Each package holds ``ref.py`` (the plain PyTorch version), ``kernel.py``
(the ctypes launcher, with its ``launches`` count) and ``ops.py`` (the
model-layout entry point: the kernel on a CUDA tensor, the plain version on
a CPU tensor). ``_build.py`` compiles ``csrc/*.cu`` with ``nvcc`` for
``sm_90a`` at first use.
"""
