"""The flash forward's row log-sum-exp and the backward that reads it, on
the CPU, against the JAX package.

``flash_attention_cuda(..., return_lse=True)`` writes each query row's fp32
log-sum-exp of the scaled, masked scores in the backward kernel's folded
layout (B, Hk, Sq * G), row ``pos * G + g``; the backward kernel
(``csrc/flash_attention_bwd.cu``) takes P = 2^(s log2(e) / sqrt(D) -
lse log2(e)) from it, delta = rowsum(dO o) and dS = P (dP - delta). Here
the plain lse (``flash_attention_lse_plain``) is held to ``jax.nn.logsumexp``
of the JAX reference's scores, and a plain backward written in the kernel's
formulas and layout, fed that lse, to ``jax.vjp`` of the JAX reference, in
fp32 from seeded numpy inputs. The split of the dk/dv pass's rows into
ranges (``split_plan``) is checked against the rows each key tile needs.

Tolerances: lse 1e-5 absolute (fp32 sums in another order; |lse| < 6
here); the gradients 1e-5 of their largest magnitude (fp64 formulas against
fp32 JAX), as ``tests/test_torch_train.py`` holds the plain backward.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_lse_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention.kernel_bwd import (
    BLOCKS_PER_SM, TILE, auto_split, split_plan)

# (B, Sq, H, Hk, D): G = 1, 3 and 8; Sq = 37 is ragged for every tile size
SHAPES = [(2, 16, 2, 2, 16), (1, 37, 6, 2, 16), (1, 24, 16, 2, 8),
          (2, 37, 8, 1, 16)]


def draw(seed, B, S, H, Hk, D):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, S, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, S, Hk, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def fold(x, Hk):
    """(B, S, H, D) numpy -> the JAX reference's (B, Hk, G, S, D)."""
    B, S, H, D = x.shape
    return jnp.asarray(x).reshape(B, S, Hk, H // Hk, D).transpose(
        0, 2, 3, 1, 4)


def jax_scores(q, k, causal):
    """The JAX reference's scaled, masked fp32 scores, built as
    ``repro.kernels.flash_attention.ref`` builds them: (B, Hk, G, Sq, Skv)."""
    Hk, D = k.shape[2], q.shape[3]
    qg, kt = fold(q, Hk), jnp.asarray(k).transpose(0, 2, 1, 3)
    s = jnp.einsum("bhgqd,bhkd->bhgqk", qg, kt) / math.sqrt(D)
    if causal:
        S, Skv = q.shape[1], k.shape[1]
        mask = jnp.arange(S)[:, None] >= jnp.arange(Skv)[None, :]
        s = jnp.where(mask[None, None, None], s, -1e30)
    return s


def jax_lse_folded(q, k, causal):
    """jax.nn.logsumexp of the reference's scores in the folded layout."""
    B, S = q.shape[:2]
    Hk = k.shape[2]
    lse = jax.nn.logsumexp(jax_scores(q, k, causal), axis=-1)  # B Hk G S
    return np.asarray(lse).transpose(0, 1, 3, 2).reshape(B, Hk, -1)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hk,D", SHAPES)
def test_lse_plain_matches_jax_logsumexp(causal, B, S, H, Hk, D):
    q, k, _, _ = draw(B * S + H, B, S, H, Hk, D)
    got = flash_attention_lse_plain(torch.as_tensor(q), torch.as_tensor(k),
                                    causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, Hk, S * H // Hk)
    np.testing.assert_allclose(got.numpy(), jax_lse_folded(q, k, causal),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hk,D", SHAPES)
def test_lse_normalizes_the_jax_reference(causal, B, S, H, Hk, D):
    """exp(s - lse) . v, with the plain lse read back from its folded rows,
    is the JAX reference's output: lse is the softmax's normalizer in the
    units and row order the backward kernel reads."""
    q, k, v, _ = draw(B * S + D, B, S, H, Hk, D)
    lse = flash_attention_lse_plain(torch.as_tensor(q), torch.as_tensor(k),
                                    causal=causal).numpy()
    G = H // Hk
    lse_g = lse.reshape(B, Hk, S, G).transpose(0, 1, 3, 2)   # B Hk G S
    p = np.exp(np.asarray(jax_scores(q, k, causal), np.float64)
               - lse_g[..., None])
    out = np.einsum("bhgqk,bhkd->bhgqd", p,
                    np.asarray(v, np.float64).transpose(0, 2, 1, 3))
    want = jax_flash_ref(fold(q, Hk), jnp.asarray(k).transpose(0, 2, 1, 3),
                         jnp.asarray(v).transpose(0, 2, 1, 3), causal=causal)
    np.testing.assert_allclose(out, np.asarray(want), rtol=0, atol=1e-5)


def kernel_formula_backward(q, k, v, o, do, lse, causal):
    """dq, dk, dv in fp64 as the backward kernel computes them, in its
    folded layout: rows R = pos * G + g of each (b, hk); P from the
    forward's lse in base 2, delta = rowsum(dO o), dS = P (dP - delta);
    dk and dv summed over the G heads of a KV head."""
    B, S, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    G = H // Hk

    def rows(x):             # (B, S, H, D) -> (B, Hk, S * G, D)
        return x.double().reshape(B, S, Hk, G, D).permute(
            0, 2, 1, 3, 4).reshape(B, Hk, S * G, D)
    Q, O, dO = rows(q), rows(o), rows(do)
    K, V = (t.double().transpose(1, 2) for t in (k, v))      # B Hk Skv D
    log2e = 1.0 / math.log(2.0)
    s = Q @ K.transpose(-1, -2)
    P = torch.exp2(s * (log2e / math.sqrt(D))
                   - lse.double()[..., None] * log2e)
    if causal:
        pos = torch.arange(S * G)[:, None] // G
        P = torch.where(torch.arange(Skv)[None, :] <= pos, P,
                        torch.zeros(()))
    delta = (dO * O).sum(-1, keepdim=True)
    dS = P * (dO @ V.transpose(-1, -2) - delta)
    dQ = dS @ K / math.sqrt(D)
    dK = dS.transpose(-1, -2) @ Q / math.sqrt(D)
    dV = P.transpose(-1, -2) @ dO
    dq = dQ.reshape(B, Hk, S, G, D).permute(0, 2, 1, 3, 4).reshape(
        B, S, H, D)
    return dq, dK.transpose(1, 2), dV.transpose(1, 2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hk,D", SHAPES)
def test_kernel_formula_backward_matches_jax_vjp(causal, B, S, H, Hk, D):
    q, k, v, do = draw(B * S + 7, B, S, H, Hk, D)
    kt, vt = (jnp.asarray(x).transpose(0, 2, 1, 3) for x in (k, v))
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_ref(a, b, c, causal=causal),
                     fold(q, Hk), kt, vt)
    jdq, jdk, jdv = vjp(fold(do, Hk))
    want = (np.asarray(jdq).transpose(0, 3, 1, 2, 4).reshape(B, S, H, D),
            np.asarray(jdk).transpose(0, 2, 1, 3),
            np.asarray(jdv).transpose(0, 2, 1, 3))
    tq, tk, tv, tdo = (torch.as_tensor(x) for x in (q, k, v, do))
    o = flash_attention_plain(tq, tk, tv, causal=causal)
    lse = flash_attention_lse_plain(tq, tk, causal=causal)
    got = kernel_formula_backward(tq, tk, tv, o, tdo, lse, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Skv,G,n_split", [
    (512, 512, 8, 4), (512, 512, 8, 1), (2048, 2048, 8, 8), (100, 100, 8, 3),
    (37, 37, 3, 2), (64, 200, 1, 2), (300, 64, 16, 64), (1, 1, 1, 1),
    # seamless-m4t's training path (G = 1): the encoder's 1024 x 1024, the
    # cross-attention's 512 queries over 1024 keys, and more queries than
    # keys; None: auto_split's n_split at its B = 8, Hk = 16 on a 132-SM
    # card, which is 1 (one range a key tile already gives 2048 blocks)
    (1024, 1024, 1, None), (512, 1024, 1, None), (1024, 512, 1, None),
    (1024, 1024, 1, 4), (512, 1024, 1, 4), (1024, 512, 1, 4)])
def test_split_plan_covers_each_reaching_row_once(causal, Sq, Skv, G,
                                                  n_split):
    """Each key tile's ranges, cut as the source's ranges_of cuts them, are
    contiguous, cover exactly the folded rows that reach its keys (pos >=
    its first key under the causal mask), hold ``span`` rows each but the
    last, and number ``ranges`` in all; the first key tile gets at most
    ``n_split`` of them."""
    if n_split is None:
        n_split = auto_split(8, 16, Sq, Skv, G, causal, 132)
        assert n_split == 1
    span, ranges = split_plan(Sq, Skv, G, causal, n_split)
    NR = Sq * G
    assert span % TILE == 0 and span >= TILE
    count = 0
    for t in range(-(-Skv // TILE)):
        lo = t * TILE * G if causal else 0
        reach = [R for R in range(NR) if not causal or R // G >= t * TILE]
        assert reach == list(range(lo, NR))[:len(reach)]
        cuts = [(a, min(a + span, NR)) for a in range(lo, NR, span)]
        assert [R for a, b in cuts for R in range(a, b)] == reach
        assert all(b - a == span for a, b in cuts[:-1])
        if t == 0:
            assert len(cuts) <= n_split
        count += len(cuts)
    assert count == ranges


@pytest.mark.parametrize("B,S,want", [(8, 512, 2), (1, 2048, 4),
                                      (1, 8, 1)])
def test_auto_split_fills_the_card(B, S, want):
    """The smallest power of two that gives the dk/dv pass BLOCKS_PER_SM
    blocks an SM of a 132-SM card: 2 at the training shape (384 blocks),
    4 at B=1, S=2048 (320); one tile of rows cannot split."""
    Hk, G, sms = 4, 8, 132
    n = auto_split(B, Hk, S, S, G, True, sms)
    assert n == want
    blocks = B * Hk * split_plan(S, S, G, True, n)[1]
    tiles = -(-S * G // TILE)
    assert blocks >= BLOCKS_PER_SM * sms or n >= tiles
    if n > 1:
        assert B * Hk * split_plan(S, S, G, True, n // 2)[1] \
            < BLOCKS_PER_SM * sms


def test_bwd_cuda_refuses_cpu_tensors_and_needs_the_forwards_lse():
    """The backward launcher takes CUDA tensors only (no plain fallback),
    and its lse is a required argument."""
    q = o = do = torch.zeros(1, 16, 2, 16, dtype=torch.bfloat16)
    k = v = torch.zeros(1, 16, 1, 16, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q, k, v, o, do, lse)
    with pytest.raises(TypeError):
        flash_attention_bwd_cuda(q, k, v, o, do)        # no lse: no path
    with pytest.raises(ValueError, match="n_split"):
        split_plan(16, 16, 2, True, 0)


def test_build_hash_covers_the_headers(tmp_path, monkeypatch):
    """A source's library name changes when a header in csrc/ that it may
    include changes, so an edited header never loads a stale library."""
    from repro_torch.kernels import _build
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._target("a")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._target("a") != before
    (tmp_path / "h.cuh").write_text("// one\n")
    assert _build._target("a") == before


def test_phases_tool_finds_each_cut_once():
    """tools/flash_bwd_phases.py cuts parts of the backward's source by
    their text: each cut is found exactly once, and each copy differs from
    the source."""
    import importlib.util
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        spec = importlib.util.spec_from_file_location(
            "flash_bwd_phases", root / "tools" / "flash_bwd_phases.py")
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        variants = tool.variants()
    finally:
        sys.path.remove(str(root))
    assert set(variants) == {"full", "dq-prologue", "dq-no-dQ", "dq-no-exp",
                             "dkdv-no-acc", "dkdv-no-exp"}
    assert all(text != variants["full"] for name, text in variants.items()
               if name != "full")


def test_ab_tool_needs_a_source_to_compare():
    """tools/flash_bwd_ab.py (card only) times the backward against another
    version of its source; without one it prints its usage and returns 2
    before it looks for a card."""
    import importlib.util
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        spec = importlib.util.spec_from_file_location(
            "flash_bwd_ab", root / "tools" / "flash_bwd_ab.py")
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
    finally:
        sys.path.remove(str(root))
    assert tool.main([]) == 2
    assert tool.main([str(root / "no-such-file.cu")]) == 2
    assert {label for label, *_ in tool.SHAPES} >= {
        "seamless-encoder", "seamless-cross", "seamless-decoder"}
