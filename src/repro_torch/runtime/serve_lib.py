"""The serving steps over a (data, model) mesh: port of
``repro/runtime/serve_lib.py``.

Cache sharding, as the reference's: batch over the data axes when they
divide it, the K/V cache's *sequence* axis over the model axis (each model
rank owns a contiguous span of rows, and a decode step is the distributed
flash-decode split-K pattern: each rank's partial (out, lse) over its span,
merged by an all_reduce of the stats, never a gather of the cache). When
the batch does not divide (long context, batch 1) the sequence takes every
axis. SSM states cut their heads over the model axis.

:func:`cache_specs` gives those specs for every family, as the reference's
do. :func:`build_prefill_step` and :func:`build_decode_step` return
callables over this rank's parameter and cache shards for every family:
``dense``, ``vlm`` (its tokens path, 1-D RoPE, as the reference's serve
steps run it), ``moe``, ``ssm``, ``hybrid`` and ``encdec``: ``(params,
tokens, cache) -> (logits, cache)`` (the encoder-decoder's prefill
``(params, frames, tokens, cache)``, as the reference's), with ``tokens``
(and ``frames``) the whole batch (every rank takes its rows) and
``logits`` the whole batch's on every rank, as the reference's steps
return them. The model's execution (``models/lm.py::_apply_cached`` and
``models/encdec.py`` with ``shard``) covers q heads, K/V heads, the MLP
and the vocab cut over the model axis (or replicated where
``rules._fits`` refuses); the experts cut over the model axis (expert
parallel, each data shard's capacity from its own tokens, as the
reference's ``shard_map`` gives it) with the shared experts' hidden
units; the Mamba heads and their ``d_inner`` columns (head parallel, the
ssd kernel on each rank's heads); a hybrid super-block's sublayers, each
cut as its own family's; the encoder (non-causal, uncached) and the
cross-attention over a memory K/V cache that holds every KV head; the
batch over the data axes and the K/V cache's sequence over the model
axis. With ``zero3=True`` the steps take each rank's ZeRO-3 regions as
``params`` (``param_specs(..., zero3=True)``: each leaf's model-axis shard
cut again over the data axes) and gather each unit's leaves to their
model-axis shards just before it runs (``sharding/layout.py``'s
``ShardLayout.gather_params``), so their logits are the non-ZeRO-3 steps'
bit for bit. A spec it does not cover (the ``head_dim`` fallback,
``expert_mlp`` cut where the experts do not divide, ``ssm_inner`` cut
without ``ssm_heads``, sequence parallelism, a cache sequence over other
axes: the long-context branch, where the batch does not divide over the
data axes) raises ``NotImplementedError`` naming ROADMAP A.12 before
anything is allocated.

The steps need a mesh over a process group (``launch/mesh.py::
make_local_mesh``): NCCL with one rank a card, gloo for ranks that share
one. The per-rank serve loop lives with its callers (``chip_smoke.py``,
``tests/test_torch_serve_lib.py``), as the reference's serve loop runs
under ``make_local_mesh()``.
"""

from __future__ import annotations

import torch

from ..launch.mesh import Mesh
from ..models.attention import KVCache
from ..models.lm import Cache
from ..models.encdec import EncDecCache
from ..models.param import tree_at, tree_items
from ..models.ssm import SSMCache
from ..sharding.context import data_axes, mesh_context, model_axis
from ..sharding.layout import ShardLayout, Span, Zero3, span_of
from ..sharding.rules import (PartitionSpec as P, local_shape, local_slices,
                              make_rules, spec_axes, spec_tree)

__all__ = ["cache_specs", "build_prefill_step", "build_decode_step",
           "abstract_cache", "param_specs", "shard_layout",
           "init_cache_shards", "zero3_of"]

# the families the sharded execution serves, and the logical axes it cuts
# over the model axis
_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
# the families it trains (``runtime/train_lib.py``'s sharded step)
_TRAIN_FAMILIES = _FAMILIES
_CUT_AXES = ("heads", "kv_heads", "mlp", "vocab", "experts", "ssm_heads",
             "ssm_inner")


def _lead(axes):
    return tuple(axes) if len(axes) > 1 else (axes[0] if axes else None)


def cache_specs(model, mesh: Mesh, batch: int, max_len: int):
    """PartitionSpec tree matching ``model.init_cache``'s structure. The
    K/V ``length`` keeps the reference's per-layer spec, P(None), on the
    port's one scalar; the encoder-decoder's ``cross_length`` scalar, which
    the reference's cache has not, is P()."""
    cfg = model.cfg
    d = data_axes(mesh)
    m = model_axis(mesh)
    nd = 1
    for a in d:
        nd *= mesh.shape[a]
    nm = mesh.shape[m] if m else 1

    batch_ok = d and batch % nd == 0
    b_ax = _lead(d) if batch_ok else None
    if batch_ok:
        seq_ax = m if (m and max_len % nm == 0) else None
    else:
        # batch unshardable (long context): give the sequence every axis
        all_ax = tuple(d) + ((m,) if m else ())
        size = nd * nm
        seq_ax = all_ax if (all_ax and max_len % size == 0) else (
            m if (m and max_len % nm == 0) else None)

    def kv_spec():
        # (L, B, S, Hk, D)
        return P(None, b_ax, seq_ax, None, None)

    def ssm_state_spec():
        # (L, B, H, P, N): heads over model
        h_ax = m if (m and cfg.ssm_heads % nm == 0) else None
        return P(None, b_ax, h_ax, None, None)

    def conv_spec():
        # (L, B, K-1, C)
        return P(None, b_ax, None, None)

    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        return Cache(kv=KVCache(k=kv_spec(), v=kv_spec(), length=P(None)))
    if fam == "ssm":
        return Cache(ssm=SSMCache(state=ssm_state_spec(),
                                  conv_x=conv_spec(), conv_B=conv_spec(),
                                  conv_C=conv_spec()))
    if fam == "hybrid":
        # kv: (nb, B, S, Hk, D); ssm leaves: (nb, nm, B, ...)
        h_ax = m if (m and cfg.ssm_heads % nm == 0) else None
        return Cache(
            kv=KVCache(k=kv_spec(), v=kv_spec(), length=P(None)),
            ssm=SSMCache(state=P(None, None, b_ax, h_ax, None, None),
                         conv_x=P(None, None, b_ax, None, None),
                         conv_B=P(None, None, b_ax, None, None),
                         conv_C=P(None, None, b_ax, None, None)))
    if fam == "encdec":
        return EncDecCache(
            self_kv=KVCache(k=kv_spec(), v=kv_spec(), length=P(None)),
            cross_k=P(None, b_ax, None, None, None),
            cross_v=P(None, b_ax, None, None, None),
            cross_length=P())
    raise ValueError(fam)


def abstract_cache(model, batch: int, max_len: int, *, filled: bool,
                   memory_len: int | None = None):
    """The cache tree on the ``meta`` device: shapes and dtypes, no
    allocation (the dry run's). ``filled`` is unused, as in the
    reference."""
    if model.cfg.family == "encdec":
        return model.init_cache(batch, max_len, memory_len or 128,
                                device="meta")
    return model.init_cache(batch, max_len, device="meta")


def param_specs(model, mesh: Mesh, *, zero3: bool = False):
    """The parameters' PartitionSpec tree, as the reference's steps take
    it: ``spec_tree(model.param_decls(), mesh, make_rules(mesh, zero3))``."""
    return spec_tree(model.param_decls(), mesh,
                     make_rules(mesh, zero3=zero3))


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: not in the sharded execution of "
                               f"the port yet (ROADMAP A.12)")


def shard_layout(model, mesh: Mesh, batch: int, max_len: int | None = None,
                 *, zero3: bool = False) -> ShardLayout:
    """This rank's :class:`~repro_torch.sharding.layout.ShardLayout` of the
    model under the reference's specs, or ``NotImplementedError`` naming
    ROADMAP A.12 for a spec the execution does not cover. Allocates
    nothing. A hybrid's layout holds every span (its block composes the
    attention, the MLP, the MoE and Mamba-2); an encoder-decoder's takes
    its attention spans from the encoder's, the decoder's self- and its
    cross-attention, and its MLP's from both stacks, each required
    alike.

    ``max_len`` None gives a training layout (``runtime/train_lib.py``'s
    sharded step): no cache and no ``seq`` span, the parameter specs
    under ``cfg.dp_only`` as ``make_train_state_specs`` takes them, and
    ``batch`` this rank's rows under ``train_lib.batch_sharding``. Every
    family trains sharded: the hybrid's block and the encoder-decoder's
    stacks take the spans that serving takes.

    ``zero3``: the spans as without it, and the layout's
    :class:`~repro_torch.sharding.layout.Zero3`: this rank's region of
    each leaf that the ZeRO-3 pass cuts (:func:`zero3_of`)."""
    cfg = model.cfg
    fam = cfg.family
    train = max_len is None
    if fam not in _FAMILIES:
        raise _unported(f"sharded serving of the {fam} family")
    if train and fam not in _TRAIN_FAMILIES:
        raise _unported(f"sharded training of the {fam} family")
    if model_axis(mesh) is None:
        raise _unported(f"a mesh without a model axis ({mesh})")
    decls = model.param_decls()
    specs = spec_tree(decls, mesh, make_rules(mesh, dp_only=cfg.dp_only)) \
        if train else param_specs(model, mesh)

    def span(paths, axis: str, total: int) -> Span:
        """This rank's span of the dim named ``axis`` of the parameter at
        ``paths`` ("layers/attn/wq"; or several, which must agree), its
        position read from the leaf's declared axis names, so that more
        leading stacked axes (a hybrid block's leaves sit under two)
        cannot shift it."""
        found = set()
        for path in (paths,) if isinstance(paths, str) else paths:
            keys = tuple(path.split("/"))
            index = tree_at(decls, keys).axes.index(axis)
            found.add(span_of(tree_at(specs, keys)[index], total, mesh))
        if len(found) > 1:
            raise _unported(f"the {axis} axis cut unlike across {paths}: "
                            f"{sorted(found, key=lambda s: s.size)}")
        return found.pop()
    kw = {"vocab": span("embed", "vocab", cfg.vocab)}
    if fam in ("moe", "hybrid"):
        kw["experts"] = span("layers/moe/w_up", "experts", cfg.n_experts)
        if not kw["experts"].sharded:
            raise _unported(
                f"the {cfg.n_experts} experts do not divide over the model "
                f"axis of {mesh}, so the specs cut expert_mlp (the "
                f"reference's shard_map cuts the experts all the same)")
        if cfg.n_shared_experts:
            kw["shared"] = span("layers/moe/shared_up", "mlp",
                                cfg.d_ff * cfg.n_shared_experts)
            if not kw["shared"].sharded:
                raise _unported(f"the shared experts' {kw['shared'].total} "
                                f"hidden units not cut over the model axis "
                                f"of {mesh}")
    if fam in ("ssm", "hybrid"):
        heads = span("layers/mamba/A_log", "ssm_heads", cfg.ssm_heads)
        inner = span("layers/mamba/w_x", "ssm_inner", cfg.d_inner)
        if heads.sharded != inner.sharded:
            raise _unported(
                f"ssm_inner {'' if inner.sharded else 'not '}cut over the "
                f"model axis of {mesh} while the {cfg.ssm_heads} ssm_heads "
                f"are{'' if heads.sharded else ' not'} (a rank's inner "
                f"columns must be its heads')")
        kw.update(ssm_heads=heads, ssm_inner=inner)
    if fam in ("dense", "vlm", "hybrid"):
        kw["mlp"] = span("layers/mlp/w_up", "mlp", cfg.d_ff)
    elif fam == "encdec":
        kw["mlp"] = span(("encoder/mlp/w_up", "decoder/mlp/w_up"), "mlp",
                         cfg.d_ff)
    for path, d in tree_items(decls):
        spec = tree_at(specs, path)
        for name, part in zip(d.axes, spec):
            if part is not None and not (part == "model"
                                         and name in _CUT_AXES):
                raise _unported(
                    f"{'/'.join(path)}: spec {spec} cuts its {name!r} axis "
                    f"over {part!r} (the head_dim fallback, where the q "
                    f"heads do not divide over the model axis)"
                    if name == "head_dim" else
                    f"{'/'.join(path)}: spec {spec} cuts its {name!r} axis "
                    f"over {part!r}")
    if zero3:
        kw["zero3"] = zero3_of(model, mesh, specs, train)
    if train:
        from .train_lib import batch_sharding
        entry = batch_sharding(mesh, {"tokens": torch.empty(
            (batch, 1), device="meta")}, dp_only=cfg.dp_only)["tokens"][0]
        cut = {"batch": span_of(entry, batch, mesh), "seq": None}
    else:
        cut = None
        cspecs = cache_specs(model, mesh, batch, max_len)
    if fam == "ssm":
        return ShardLayout(mesh=mesh, batch=cut["batch"] if train else
                           span_of(cspecs.ssm.state[1], batch, mesh), **kw)
    if cut is None:
        kv = (cspecs.self_kv if fam == "encdec" else cspecs.kv).k
        if kv[2] != "model":
            raise _unported(f"a K/V cache spec {kv} whose sequence is not "
                            f"cut over the model axis alone (max_len "
                            f"{max_len} on {mesh})")
        cut = {"batch": span_of(kv[1], batch, mesh),
               "seq": span_of(kv[2], max_len, mesh)}
    attn = ("encoder/attn", "decoder/self_attn", "decoder/cross_attn") \
        if fam == "encdec" else ("layers/attn",)
    heads = span(tuple(f"{a}/wq" for a in attn), "heads", cfg.n_heads_eff)
    G = cfg.n_heads_eff // cfg.n_kv_heads
    if heads.size % G and G % heads.size:
        raise _unported(f"{heads.size} q heads a rank with groups of {G}")
    return ShardLayout(
        mesh=mesh, heads=heads,
        kv_heads=span(tuple(f"{a}/wk" for a in attn), "kv_heads",
                      cfg.n_kv_heads), **cut, **kw)


def zero3_of(model, mesh: Mesh, specs, train: bool) -> Zero3 | None:
    """This rank's :class:`~repro_torch.sharding.layout.Zero3` over the
    parameters whose specs without ZeRO-3 are ``specs``: the ZeRO-3 specs
    (training's under ``cfg.dp_only``, as ``make_train_state_specs`` takes
    them; serving's ``param_specs(..., zero3=True)``), and for each leaf
    they cut further, the region of its shard under ``specs`` that the
    rank holds. None where they cut nothing further (a data axis of one
    rank). A ZeRO-3 spec must be ``specs``' with the pass's axes on one
    more dim."""
    cfg = model.cfg
    rules = make_rules(mesh, zero3=True,
                       dp_only=cfg.dp_only if train else False)
    decls = model.param_decls()
    zspecs = spec_tree(decls, mesh, rules)
    axes = tuple(rules["_zero3"] or ())
    regions, shapes = {}, {}
    for path, d in tree_items(decls):
        spec, zspec = tree_at(specs, path), tree_at(zspecs, path)
        added = [i for i, (a, b) in enumerate(zip(spec, zspec)) if a != b]
        if len(added) > 1 or (added and (spec[added[0]] is not None or
                                         spec_axes(zspec[added[0]]) != axes)):
            raise _unported(f"{'/'.join(path)}: the ZeRO-3 spec {zspec} "
                            f"is not {spec} cut over {axes} on one more dim")
        shard = local_slices(spec, d.shape, mesh)
        mine = local_slices(zspec, d.shape, mesh)
        if shard == mine:
            continue
        regions[path] = tuple(slice(m.start - s.start, m.stop - s.start)
                              for s, m in zip(shard, mine))
        shapes[path] = tuple(s.stop - s.start for s in shard)
    return Zero3(regions, shapes, axes) if regions else None


def init_cache_shards(model, mesh: Mesh, batch: int, max_len: int, *,
                      memory_len: int | None = None,
                      device: str | torch.device = "cuda"):
    """This rank's zero cache shards under :func:`cache_specs`, each
    ``length`` the global one, an int32 scalar: the K/V cache
    (n_layers, local batch, local rows, kv_heads, head_dim) (families
    dense, vlm, moe; a hybrid's a block); the SSM cache (family ssm:
    ``state`` (n_layers, local batch, local heads, P, N) fp32 and the conv
    tails (n_layers, local batch, K-1, channels); a hybrid's each with
    (blocks, Mamba sublayers) in front), ``conv_x`` with every ``d_inner``
    column on every model rank, as the reference's spec keeps it; the
    encoder-decoder's fp32 self K/V over the local rows, and its bf16
    ``cross_k``/``cross_v`` (n_layers, local batch, ``memory_len``,
    kv_heads, head_dim) with every KV head, the spec's, and
    ``cross_length`` = ``memory_len`` (the reference's 128 when None, as
    :func:`abstract_cache`)."""
    full = abstract_cache(model, batch, max_len, filled=False,
                          memory_len=memory_len)
    specs = cache_specs(model, mesh, batch, max_len)

    def zeros(spec, like):
        return torch.zeros(local_shape(spec, tuple(like.shape), mesh),
                           dtype=like.dtype, device=device)

    def kv(spec, like):
        return None if like is None else KVCache(
            k=zeros(spec.k, like.k), v=zeros(spec.v, like.v),
            length=torch.zeros((), dtype=torch.int32, device=device))
    if model.cfg.family == "encdec":
        return EncDecCache(
            self_kv=kv(specs.self_kv, full.self_kv),
            cross_k=zeros(specs.cross_k, full.cross_k),
            cross_v=zeros(specs.cross_v, full.cross_v),
            cross_length=torch.tensor(full.cross_k.shape[2],
                                      dtype=torch.int32, device=device))
    ssm = None if full.ssm is None else SSMCache(
        *(zeros(spec, like) for spec, like in zip(specs.ssm, full.ssm)))
    return Cache(kv=kv(specs.kv, full.kv), ssm=ssm)


def _step(model, mesh: Mesh, layout: ShardLayout, method: str, seq: int,
          n_inputs: int = 1):
    if not mesh.is_live:
        raise ValueError(f"the serving steps run on a mesh over a process "
                         f"group (make_local_mesh), not {mesh}")
    run = getattr(model, method)
    batch = layout.batch

    def step(params, *args):
        """``args``: the ``n_inputs`` whole-batch inputs (the tokens last),
        then the cache."""
        if len(args) != n_inputs + 1:
            raise TypeError(f"the step takes {n_inputs} input(s) and the "
                            f"cache, got {len(args)} arguments")
        *inputs, cache = args
        if tuple(inputs[-1].shape) != (batch.total, seq) or any(
                t.shape[0] != batch.total for t in inputs):
            raise ValueError(f"inputs {[tuple(t.shape) for t in inputs]}: "
                             f"the step was built for tokens "
                             f"({batch.total}, {seq})")
        with mesh_context(mesh), torch.no_grad():
            return run(params, *(t[batch.slice()] for t in inputs), cache,
                       shard=layout)
    return step


def build_prefill_step(model, mesh: Mesh, batch: int, seq: int,
                       max_len: int | None = None, *, zero3: bool = False):
    """``prefill(params, tokens (batch, seq), cache) -> (last-token logits
    (batch, 1, vocab), cache)`` on this rank's shards; the cache is empty
    before it. The encoder-decoder's is ``prefill(params, frames (batch,
    T, M), tokens (batch, seq), cache)``, as the reference's, with a cache
    made for T frames (``init_cache_shards(..., memory_len=T)``). With
    ``zero3``, ``params`` are the rank's regions under
    ``param_specs(..., zero3=True)``, each unit gathered before it runs,
    under ``no_grad``."""
    layout = shard_layout(model, mesh, batch, max_len or seq, zero3=zero3)
    return _step(model, mesh, layout, "prefill", seq,
                 2 if model.cfg.family == "encdec" else 1)


def build_decode_step(model, mesh: Mesh, batch: int, max_len: int, *,
                      zero3: bool = False):
    """``decode(params, token (batch, 1), cache) -> (logits (batch, 1,
    vocab), cache)`` on this rank's shards (with ``zero3``, its regions, as
    :func:`build_prefill_step`)."""
    layout = shard_layout(model, mesh, batch, max_len, zero3=zero3)
    return _step(model, mesh, layout, "decode_step", 1)
