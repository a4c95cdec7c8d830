"""The port's parameter schema, its seeded init, and the bridge that carries
JAX parameters across (``params_from_numpy``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config, list_archs
from repro_torch.models import build_model, init_params, params_from_numpy
from repro_torch.models.param import param_count

TORCH_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32}
NEW_ARCHS = ["starcoder2-15b", "nemotron-4-15b", "qwen3-14b",
             "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b",
             "seamless-m4t-large-v2", "qwen2-vl-72b"]
ARCHS = ["tinyllama-1.1b", "mamba2-370m"] + NEW_ARCHS
# parameter counts of the full configs (analysis/flops.py's figures):
# tinyllama ~1.1 B; mamba2-370m ~367 M; the 15 B archs with an untied head,
# qwen3's lowered at 48 heads (15.19 B; 14.77 B at its 40); qwen3-moe
# 235.09 B at its 94 layers, 128 experts each; kimi-k2 1043.85 B at its 61
# layers, 384 experts and one shared expert each; seamless-m4t 1.632 B
# (encoder 503.4 M, decoder 604.1 M, embedding and head 524.7 M);
# qwen2-vl 72.705 B at its 80 layers of 0.878 B, with 2.491 B of
# embedding and untied head
FULL_PARAMS = {"tinyllama-1.1b": (1.0e9, 1.2e9),
               "mamba2-370m": (3.4e8, 3.9e8),
               "starcoder2-15b": (1.55e10, 1.65e10),
               "nemotron-4-15b": (1.55e10, 1.60e10),
               "qwen3-14b": (1.50e10, 1.55e10),
               "qwen3-moe-235b-a22b": (2.35e11, 2.36e11),
               "kimi-k2-1t-a32b": (1.043e12, 1.044e12),
               "seamless-m4t-large-v2": (1.631e9, 1.633e9),
               "qwen2-vl-72b": (7.270e10, 7.271e10)}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_param_schema_matches_jax(reduced, arch):
    """Same tree paths, shapes and dtypes as LM.param_decls() (the full
    config too: the schema is shapes only, nothing is allocated)."""
    jdecls = _paths(jax_build_model(
        jax_get_config(arch, reduced=reduced)).param_decls())
    tdecls = _paths(build_model(
        get_config(arch, reduced=reduced)).param_decls())
    assert set(jdecls) == set(tdecls)
    for path, jd in jdecls.items():
        td = tdecls[path]
        assert tuple(jd.shape) == td.shape, path
        assert tuple(jd.axes) == td.axes, path
        assert TORCH_DTYPE[jnp.dtype(jd.dtype).name] == td.dtype, path
    if not reduced:
        lo, hi = FULL_PARAMS[arch]
        assert lo < param_count(build_model(
            get_config(arch)).param_decls()) < hi


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_keeps_paths_shapes_dtypes_bits(arch):
    cfg = jax_get_config(arch, reduced=True)
    params = jax_init_params(jax_build_model(cfg).param_decls(),
                             jax.random.key(0))
    # an fp32 leaf beside the bf16 ones: the bridge keeps each leaf's dtype
    params["extra_fp32"] = jnp.arange(6, dtype=jnp.float32).reshape(2, 3)
    exported = jax.tree.map(np.asarray, params)
    got = _paths(params_from_numpy(exported, "cpu"))
    want = _paths(exported)
    assert set(got) == set(want)
    for path, a in want.items():
        t = got[path]
        assert tuple(t.shape) == a.shape, path
        assert t.dtype == TORCH_DTYPE[a.dtype.name], path
        if a.dtype.name == "bfloat16":     # bit-exact through uint16
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16)), path
        else:
            assert np.array_equal(t.numpy(), a), path


def test_init_params_shapes_dtypes_and_distributions():
    cfg = get_config("tinyllama-1.1b", reduced=True)
    decls = _paths(build_model(cfg).param_decls())
    params = _paths(init_params(build_model(cfg).param_decls(),
                                torch.Generator().manual_seed(0), "cpu"))
    assert set(params) == set(decls)
    for path, d in decls.items():
        assert tuple(params[path].shape) == d.shape, path
        assert params[path].dtype == d.dtype, path
    for norm in (("final_norm",), ("layers", "ln1"), ("layers", "ln2")):
        assert bool((params[norm] == 1).all())
    # normal_init(0.02) for the embedding; fan-in normal (1/sqrt(fan_in))
    # elsewhere; sample stds within 10% at these sizes (>= 16k draws)
    assert abs(params[("embed",)].float().std().item() - 0.02) < 0.002
    wq = params[("layers", "attn", "wq")].float()     # (L, M, H, D): fan-in H
    assert abs(wq.std().item() - 1 / np.sqrt(wq.shape[-2])) < 0.1 / np.sqrt(
        wq.shape[-2])
    w_up = params[("layers", "mlp", "w_up")].float()  # (L, M, F): fan-in M
    assert abs(w_up.std().item() - 1 / np.sqrt(64)) < 0.1 / np.sqrt(64)


def test_large_leaves_are_drawn_in_slices(monkeypatch):
    """A leaf over ``_SLICE_ELEMENTS`` is drawn slice by slice along its
    leading axis straight into its dtype: no fp32 draw larger than the
    threshold (or than one row), the same tensor for the same seed, the same
    distribution. At the real threshold (2^30) qwen3-moe's (12, 128, 4096,
    1536) expert leaves draw 805 M elements at a time where one draw took
    9.66 G (38.7 GB of fp32)."""
    from repro_torch.models import param
    monkeypatch.setattr(param, "_SLICE_ELEMENTS", 9000)   # 2 rows a slice
    draws = []
    randn = torch.randn

    def counting(*args, **kw):
        out = randn(*args, **kw)
        draws.append(out.numel())
        return out
    monkeypatch.setattr(torch, "randn", counting)
    decls = {"w": param.ArrayDecl((12, 8, 32, 16), ("layers", None, "embed",
                                                   None)),
             "small": param.ArrayDecl((4, 16), ("embed", None))}
    a = init_params(decls, torch.Generator().manual_seed(5), "cpu")
    assert max(draws) <= 9000 and len(draws) == 12 // 2 + 1
    assert a["w"].dtype == torch.bfloat16 and a["w"].shape == (12, 8, 32, 16)
    b = init_params(decls, torch.Generator().manual_seed(5), "cpu")
    assert torch.equal(a["w"], b["w"]) and torch.equal(a["small"],
                                                       b["small"])
    std = a["w"].float().std().item()          # fan-in 32 (axis -2)
    assert abs(std - 1 / np.sqrt(32)) < 0.05 / np.sqrt(32)


def test_rows_over_the_threshold_are_drawn_row_by_row(monkeypatch):
    """A leaf one row of whose leading axis is itself over
    ``_SLICE_ELEMENTS`` is drawn row by row, each row in slices of its own
    leading axis: no fp32 draw over the threshold. At the real threshold
    kimi-k2-1t-a32b's (2, 384, 7168, 2048) expert leaves draw 73 of a
    layer's 384 experts (1.07 G elements) at a time where a layer alone is
    5.6 G (22.5 GB of fp32)."""
    from repro_torch.models import param
    monkeypatch.setattr(param, "_SLICE_ELEMENTS", 1200)   # 2 of 8 a slice
    draws = []
    randn = torch.randn

    def counting(*args, **kw):
        out = randn(*args, **kw)
        draws.append(out.numel())
        return out
    monkeypatch.setattr(torch, "randn", counting)
    decls = {"w": param.ArrayDecl((3, 8, 32, 16), ("layers", None, "embed",
                                                  None))}
    a = init_params(decls, torch.Generator().manual_seed(6), "cpu")["w"]
    assert max(draws) <= 1200 and len(draws) == 3 * (8 // 2)
    b = init_params(decls, torch.Generator().manual_seed(6), "cpu")["w"]
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert len(set(a[:, :, 0, 0].flatten().tolist())) == 24   # no repeats
    std = a.float().std().item()               # fan-in 32 (axis -2)
    assert abs(std - 1 / np.sqrt(32)) < 0.05 / np.sqrt(32)


def test_init_params_is_seeded():
    decls = build_model(get_config("tinyllama-1.1b",
                                   reduced=True)).param_decls()
    a = _paths(init_params(decls, torch.Generator().manual_seed(3), "cpu"))
    b = _paths(init_params(decls, torch.Generator().manual_seed(3), "cpu"))
    c = _paths(init_params(decls, torch.Generator().manual_seed(4), "cpu"))
    assert all(torch.equal(a[p], b[p]) for p in a)
    assert not torch.equal(a[("embed",)], c[("embed",)])


def test_configs_registry():
    assert list_archs() == ARCHS
    cfg = get_config("tinyllama-1.1b")
    ref = jax_get_config("tinyllama-1.1b")
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "head_dim", "rope_theta", "activation", "glu"):
        assert getattr(cfg, field) == getattr(ref, field), field
    red, red_ref = get_config("tinyllama-1.1b", reduced=True), \
        jax_get_config("tinyllama-1.1b", reduced=True)
    assert (red.n_layers, red.d_model, red.n_heads, red.n_kv_heads,
            red.head_dim, red.vocab, red.q_chunk) == \
        (red_ref.n_layers, red_ref.d_model, red_ref.n_heads,
         red_ref.n_kv_heads, red_ref.head_dim, red_ref.vocab,
         red_ref.q_chunk)
    with pytest.raises(KeyError, match="ROADMAP item A.10"):
        get_config("jamba-1.5-large-398b")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("reduced", [True, False])
def test_mamba2_config_matches_jax_field_by_field(reduced):
    cfg = get_config("mamba2-370m", reduced=reduced)
    ref = jax_get_config("mamba2-370m", reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert (cfg.ssm_heads, cfg.d_inner) == (ref.ssm_heads, ref.d_inner)
    if not reduced:       # H = 32 heads of P = 64, N = 128, conv K = 4
        assert (cfg.n_layers, cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim,
                cfg.ssm_state, cfg.ssm_conv, cfg.vocab) == \
            (48, 1024, 32, 64, 128, 4, 50280)


def test_mamba2_init_params_distributions():
    """The SSM initializers: softplus(dt_bias) lies in [1e-3, 1e-1],
    A_log = log(1..H) on every layer, D = 1, all three fp32; the conv
    weights normal(0.1) in bf16."""
    cfg = get_config("mamba2-370m", reduced=True)
    params = _paths(init_params(build_model(cfg).param_decls(),
                                torch.Generator().manual_seed(0), "cpu"))
    L, H = cfg.n_layers, cfg.ssm_heads
    dt_bias = params[("layers", "mamba", "dt_bias")]
    a_log = params[("layers", "mamba", "A_log")]
    d = params[("layers", "mamba", "D")]
    for t in (dt_bias, a_log, d):
        assert t.dtype == torch.float32 and tuple(t.shape) == (L, H)
    dt = torch.nn.functional.softplus(dt_bias.double())
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    want = torch.log(torch.arange(1, H + 1, dtype=torch.float32))
    assert torch.equal(a_log, want.expand(L, H))
    assert bool((d == 1).all())
    conv = params[("layers", "mamba", "conv_x")]
    assert conv.dtype == torch.bfloat16
    assert abs(conv.float().std().item() - 0.1) < 0.01


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_config_matches_jax_field_by_field(reduced, arch):
    cfg = get_config(arch, reduced=reduced)
    ref = jax_get_config(arch, reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.n_heads_eff == ref.n_heads_eff


def test_qwen2_vl_config_and_schema():
    """qwen2-vl-72b: the vlm family with M-RoPE at theta 1e6 over head_dim
    128 (sections (16, 24, 24)), 64 heads over 8 KV heads, the dense
    layer's SwiGLU MLP and an untied head; 0.8777 B parameters a layer."""
    cfg = get_config("qwen2-vl-72b")
    assert (cfg.family, cfg.use_mrope, cfg.rope_theta, cfg.head_dim,
            cfg.n_heads, cfg.n_kv_heads, cfg.tie_embeddings) == \
        ("vlm", True, 1e6, 128, 64, 8, False)
    layers = build_model(cfg).param_decls()["layers"]
    assert set(layers) == {"ln1", "attn", "ln2", "mlp"}
    assert layers["mlp"]["w_gate"].shape == (80, 8192, 29568)
    one = dataclasses.replace(cfg, n_layers=1)
    per_layer = param_count(build_model(cfg).param_decls()) - param_count(
        build_model(one).param_decls())
    assert per_layer == 79 * 877_674_496


def test_qwen3_schema_has_qk_norm_and_padded_heads():
    """qwen3-14b: q_norm and k_norm (L, D) leaves, ones at init; wq and wo
    lowered at 48 heads (40 real) over 8 KV heads."""
    cfg = get_config("qwen3-14b")
    attn = build_model(cfg).param_decls()["layers"]["attn"]
    assert attn["q_norm"].shape == attn["k_norm"].shape == (40, 128)
    assert attn["wq"].shape == (40, 5120, 48, 128)
    assert attn["wo"].shape == (40, 48, 128, 5120)
    assert attn["wk"].shape == (40, 5120, 8, 128)
    small = dataclasses.replace(cfg.reduced(), pad_heads_to=6)
    params = init_params(build_model(small).param_decls(),
                         torch.Generator().manual_seed(0), "cpu")
    assert bool((params["layers"]["attn"]["q_norm"] == 1).all())
    assert params["layers"]["attn"]["wq"].shape[-2] == 6
