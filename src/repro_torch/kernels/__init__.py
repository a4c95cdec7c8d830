"""Hand-written CUDA kernels of the port, one per Pallas TPU kernel of the
JAX package's ``repro.kernels`` that the port's paths run.

* ``flash_attention``  — blocked online-softmax attention (prefill and the
  training forward), causal and GQA-native; ``csrc/flash_attention.cu``.
  Under grad on the card its gradient is ``csrc/flash_attention_bwd.cu``
  (a dq pass and a dk/dv pass; the JAX package has no backward kernel).
* ``decode_attention`` — one new token against the KV cache, masked to a
  device-side length; ``csrc/decode_attention.cu``.
* ``ssd``              — the Mamba-2 SSD chunked scan (prefill and the
  training forward), carrying an fp32 state from chunk to chunk;
  ``csrc/ssd.cu``. Under grad on the card its gradient is
  ``csrc/ssd_bwd.cu`` (the JAX package has no backward kernel).

Each package holds ``ref.py`` (the plain PyTorch version), ``kernel.py``
(the ctypes launcher, with its ``launches`` count; the backwards' are
``flash_attention/kernel_bwd.py`` and ``ssd/kernel_bwd.py``) and ``ops.py``
(the model-layout entry point: the kernel on a CUDA tensor, the plain
version on a CPU tensor). ``_build.py`` compiles ``csrc/*.cu`` with
``nvcc`` for ``sm_90a`` at first use.
"""
