"""One rank of a sharded serving group on the CPU, for
``tests/test_torch_serve_lib.py`` and
``tests/test_torch_serve_lib_families.py``: a gloo process group over a
``file://`` rendezvous, the port's (data, model) mesh, and for each case
the sharded prefill (an encoder-decoder's over the case's frames) and
teacher-forced decode steps of ``runtime/serve_lib.py`` (a case with MoE
layers also fed a routing), or a case's own function of the rank's mesh
(``"run"``: the decoder layer of ``decoder_layer_case``, or the sharded
train step of ``train_case`` for ``tests/test_torch_train_sharded.py``).
It imports no JAX, so a spawned rank starts with torch alone."""

from __future__ import annotations

import contextlib
import functools
import traceback

import torch
import torch.distributed as dist


def _shapes(tree) -> dict:
    from repro_torch.models.param import tree_items
    return {"/".join(path): tuple(a.shape) for path, a in tree_items(tree)
            if a is not None}


def _steps(model, mesh, params, tokens, prompt: int, max_len: int,
           span=None, frames=None) -> tuple:
    """The sharded prefill of ``tokens[:, :prompt]`` (over ``frames``, an
    encoder-decoder's) and a decode step fed each of ``tokens[:,
    prompt:]``: (each step's logits, fp32 numpy, the whole batch; the
    cache after; each decode step's valid keys in ``span``, this rank's
    rows of the K/V cache)."""
    from repro_torch.runtime import serve_lib
    B, T = tokens.shape
    inputs = () if frames is None else (frames,)
    cache = serve_lib.init_cache_shards(
        model, mesh, B, max_len, device="cpu",
        memory_len=None if frames is None else frames.shape[1])
    prefill = serve_lib.build_prefill_step(model, mesh, B, prompt, max_len)
    decode = serve_lib.build_decode_step(model, mesh, B, max_len)
    out, keys = [], []
    with torch.inference_mode():
        logits, cache = prefill(params, *inputs, tokens[:, :prompt], cache)
        out.append(logits.float().numpy())
        for t in range(prompt, T):
            if span is not None:
                # the rank's valid keys in this step, once the token is
                # written
                keys.append(max(0, min(t + 1 - span.start, span.size)))
            logits, cache = decode(params, tokens[:, t:t + 1], cache)
            out.append(logits.float().numpy())
    return out, cache, keys


@contextlib.contextmanager
def _routing(rows: slice, batch: int, fed: list | None, own: list):
    """Context: each call of the port's MoE routing appends its own
    (topi, gates, router logits) to ``own``; with ``fed`` (one (topi,
    gates) a call, numpy, the whole batch's T rows), it returns the fed
    routing's ``rows`` of the batch in place of its own."""
    import importlib
    from repro_torch.models.common import matmul
    moe_mod = importlib.import_module("repro_torch.models.moe")
    route, calls = moe_mod._route, iter(fed or ())

    def routed(router, x, cfg, **kw):
        topi, gates, aux = route(router, x, cfg, **kw)
        own.append((topi.numpy(), gates.numpy(), matmul(
            x.float().reshape(-1, x.shape[-1]), router).numpy()))
        if fed is None:
            return topi, gates, aux
        k = cfg.top_k
        topi, gates = (torch.as_tensor(a).reshape(batch, -1, k)[rows]
                       .reshape(-1, k) for a in next(calls))
        return topi, gates, aux
    moe_mod._route = routed
    try:
        yield
    finally:
        moe_mod._route = route


def serve_case(mesh, case: dict) -> dict:
    """The sharded prefill and teacher-forced decode steps (``_steps``) on
    ``case["params"]`` cut to this rank's shards (over ``case["frames"]``,
    an encoder-decoder's). Returns the logits of each step (fp32 numpy,
    the whole batch), this rank's parameter and cache shapes, and its
    cache after the steps: with a K/V cache (an encoder-decoder's self
    cache), each decode step's valid keys in this rank's span; with an SSM
    cache, its heads; an encoder-decoder's memory K/V (``cross``). A case
    with MoE layers also returns its routing of each call (``routes``) and
    runs again fed the case's ``routes`` of its data axis's size
    (``logits_fed``; its caches are the fed run's). A case with ``"run"``
    returns ``run(mesh, case)`` alone."""
    if "run" in case:
        return case["run"](mesh, case)
    from repro_torch.models import build_model
    from repro_torch.models.param import shard_params
    from repro_torch.runtime import serve_lib
    model = build_model(case["cfg"])
    tokens = torch.as_tensor(case["tokens"])
    frames = case.get("frames")
    if frames is not None:
        frames = torch.as_tensor(frames)
    B = tokens.shape[0]
    S, max_len = case["prompt"], case["max_len"]
    layout = serve_lib.shard_layout(model, mesh, B, max_len)
    params = shard_params(case["params"], serve_lib.param_specs(model, mesh),
                          mesh)
    span = layout.seq
    out = {"params": _shapes(params),
           "cache": _shapes(serve_lib.init_cache_shards(
               model, mesh, B, max_len, device="cpu",
               memory_len=None if frames is None else frames.shape[1]))}
    own = []
    with _routing(layout.batch.slice(), B, None, own):
        out["logits"], cache, keys = _steps(model, mesh, params, tokens, S,
                                            max_len, span, frames)
    if "routes" in case:
        out["routes"] = own
        fed = case["routes"][mesh.shape["data"]]
        with _routing(layout.batch.slice(), B, fed, []):
            out["logits_fed"], cache, _ = _steps(model, mesh, params, tokens,
                                                 S, max_len, span, frames)
    if getattr(cache, "ssm", None) is not None:
        out["heads"] = (layout.ssm_heads.start, layout.ssm_heads.size)
        out["ssm"] = tuple(a.numpy() for a in cache.ssm)
    kv = cache.self_kv if frames is not None else cache.kv
    if kv is not None:
        out.update(span_keys=keys, span=(span.start, span.size),
                   length=int(kv.length),
                   kv=(kv.k.float().numpy(), kv.v.float().numpy()))
    if frames is not None:
        out["cross"] = (cache.cross_k.float().numpy(),
                        cache.cross_v.float().numpy())
    return out


def zero3_serve_case(mesh, case: dict) -> dict:
    """``serve_case``'s steps (``_steps``: the prefill, then teacher-forced
    decode steps) on ``case["params"]`` (the whole tree) twice on this
    rank: on its shards under ``param_specs(model, mesh)`` and on its
    ZeRO-3 regions under ``param_specs(..., zero3=True)`` with the
    ZeRO-3 steps. Returns, by run ("shards", "zero3"): each step's logits
    (fp32 numpy, the whole batch), the cache after the steps (each leaf's
    bits), the all_reduce calls of the decode steps, and the parameters'
    bytes on the rank."""
    from repro_torch.models import build_model
    from repro_torch.models.param import shard_params, tree_items
    from repro_torch.runtime import serve_lib
    model = build_model(case["cfg"])
    tokens = torch.as_tensor(case["tokens"])
    frames = case.get("frames")
    frames = None if frames is None else torch.as_tensor(frames)
    B, S, T = tokens.shape[0], case["prompt"], case["max_len"]
    out = {}
    for name, zero3 in (("shards", False), ("zero3", True)):
        params = shard_params(case["params"], serve_lib.param_specs(
            model, mesh, zero3=zero3), mesh)
        count = [0]
        cache = serve_lib.init_cache_shards(
            model, mesh, B, T, device="cpu",
            memory_len=None if frames is None else frames.shape[1])
        prefill = serve_lib.build_prefill_step(model, mesh, B, S, T,
                                               zero3=zero3)
        decode = serve_lib.build_decode_step(model, mesh, B, T, zero3=zero3)
        inputs = () if frames is None else (frames,)
        logits, cache = prefill(params, *inputs, tokens[:, :S], cache)
        steps = [logits.float().numpy()]
        with chip_smoke().counting_all_reduce(torch, count):
            for t in range(S, tokens.shape[1]):
                logits, cache = decode(params, tokens[:, t:t + 1], cache)
                steps.append(logits.float().numpy())
        out[name] = {
            "logits": steps,
            "cache": {"/".join(p): leaf_bits(a) for p, a in tree_items(cache)
                      if a is not None},
            "collectives": count[0],
            "bytes": sum(a.numel() * a.element_size()
                         for _, a in tree_items(params))}
    return out


def decoder_layer_case(mesh, case: dict) -> dict:
    """A reduced encoder-decoder's decoder layer 0 on this rank, sharded,
    against the same layer unsharded (the whole batch, every weight): a
    prefill over ``case["x"][:, :prompt]`` (hidden states, bf16) that fills
    the fp32 self cache, then a decode step fed each further position, the
    cross-attention over ``case["cross"]``'s memory K/V (every head, as
    each rank's cache holds it). Returns each step's output of this rank's
    rows on both paths (fp32 numpy) and the (q, cache) dtypes of every
    call of the partial decode entry."""
    import importlib
    from repro_torch.models import build_model
    from repro_torch.models.attention import KVCache
    from repro_torch.models.param import shard_params, unstack_layers
    from repro_torch.runtime import serve_lib
    from repro_torch.sharding.context import mesh_context
    attn_mod = importlib.import_module("repro_torch.models.attention")
    model = build_model(case["cfg"])
    x = torch.as_tensor(case["x"])
    cross_k, cross_v = (torch.as_tensor(a) for a in case["cross"])
    B, T, _ = x.shape
    S, max_len, L = case["prompt"], case["max_len"], model.cfg.n_layers
    layout = serve_lib.shard_layout(model, mesh, B, max_len)
    rows = layout.batch.slice()
    specs = serve_lib.param_specs(model, mesh)
    lp = unstack_layers(shard_params(case["params"], specs, mesh)["decoder"],
                        L)[0]
    lp_full = unstack_layers(case["params"]["decoder"], L)[0]
    cross_len = torch.tensor(cross_k.shape[2], dtype=torch.int32)
    # the partial entry's (q, cache) dtypes, call by call
    seen = []
    partial = attn_mod._decode_partial_core

    def recording(q, k, v, n):
        seen.append((str(q.dtype), str(k.dtype)))
        return partial(q, k, v, n)
    runs = {"rows": (rows.start, rows.stop), "partial_dtypes": seen}
    for name, shard, params, b in (("sharded", layout, lp, rows),
                                   ("unsharded", None, lp_full, slice(None))):
        if shard is None:
            kv = model.init_cache(B, max_len, cross_k.shape[2],
                                  device="cpu").self_kv
        else:
            kv = serve_lib.init_cache_shards(
                model, mesh, B, max_len, memory_len=cross_k.shape[2],
                device="cpu").self_kv
        self_kv = KVCache(kv.k[0], kv.v[0], kv.length)
        cross = KVCache(cross_k[0, b], cross_v[0, b], cross_len)
        out = []
        attn_mod._decode_partial_core = recording
        try:
            with torch.inference_mode(), mesh_context(mesh):
                for t0, t1 in [(0, S)] + [(t, t + 1) for t in range(S, T)]:
                    y, self_kv = model._decoder_layer(
                        params, x[b, t0:t1], None, self_cache=self_kv,
                        cross_kv=cross, shard=shard)
                    out.append(y[:, -1].float().numpy())
        finally:
            attn_mod._decode_partial_core = partial
        runs[name] = out
    return runs


@functools.lru_cache(maxsize=None)
def chip_smoke():
    """``chip_smoke.py`` as a module: the planted faults and the rules of
    its sharded training check, the same code on the CPU and the card."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def microbatch_routes(record: list | None = None, fed: list | None = None,
                      group: slice = slice(None)):
    """Context for a train step with MoE layers. Each microbatch (a call of
    ``train_lib._loss_and_grads``) keys its MoE layers by their router's
    bits, in the order of their first call (remat's recompute calls a
    layer again): with ``record``, each layer's top-k experts (T, k) numpy
    appended to ``record``'s list of that microbatch; with ``fed`` (such
    lists, each of a whole global microbatch), each layer takes its top-k
    experts from them, at ``group`` of the microbatch's sequences, and
    forms its gates and aux loss by the port's own ``_router_probs`` and
    ``_gates_and_aux``, as ``chip_smoke.experts_as`` does, so the gradient
    reaches the router as it does on its own routing."""
    import importlib
    from repro_torch.runtime import train_lib
    moe_mod = importlib.import_module("repro_torch.models.moe")
    smoke = chip_smoke()
    state = {"mb": -1, "layers": {}}

    def counted(loss_and_grads):
        def run(*args, **kw):
            state["mb"] += 1
            state["layers"] = {}
            if record is not None:
                record.append([])
            return loss_and_grads(*args, **kw)
        return run

    def routing(route):
        def run(router, x, cfg, shard=None):
            layers = state["layers"]
            # a layer by its router's bits: under ZeRO-3 each call (the
            # forward's and remat's recompute) gathers it anew
            key = router.detach().cpu().numpy().tobytes()
            first = key not in layers
            if first:
                layers[key] = len(layers)
            if fed is None:
                out = route(router, x, cfg, **(
                    {} if shard is None else {"shard": shard}))
                if first:
                    record[-1].append(out[0].numpy().copy())
                return out
            k = cfg.top_k
            topi = torch.as_tensor(fed[state["mb"]][layers[key]]).reshape(
                -1, x.shape[1], k)[group]
            topi = topi.reshape(-1, k)
            probs = moe_mod._router_probs(router, x)
            return (topi,) + moe_mod._gates_and_aux(probs, topi, cfg, shard)
        return run
    with smoke.patched(train_lib, "_loss_and_grads", counted), \
            smoke.patched(moe_mod, "_route", routing):
        yield


def fed_routes(case: dict, mesh, batch: int, mu: int):
    """``microbatch_routes`` feeding ``case["routes"]`` (the record for the
    mesh's data axis) at this data rank's rows of each microbatch of
    ``batch`` sequences in ``mu``; no context for a case without routes."""
    if "routes" not in case:
        return contextlib.nullcontext()
    data, d = mesh.shape["data"], mesh.coords["data"]
    n = batch // (mu * data)
    return microbatch_routes(fed=case["routes"][data],
                             group=slice(d * n, (d + 1) * n))


@contextlib.contextmanager
def counting_cores(counts: dict):
    """Context: the calls of the attention's and the Mamba block's cores
    that the card's kernels carry, counted on the CPU's plain path into
    ``counts`` under the kernels' names: each forward of
    ``attention._prefill_core`` ("flash_attention") and ``ssm.ssd``
    ("ssd"), and each backward through their outputs
    ("flash_attention_bwd", "ssd_bwd"; an identity Function on the output
    counts its gradient's pass), where the card launches the flash and
    ssd kernels and their backward kernels."""
    import importlib
    attn_mod = importlib.import_module("repro_torch.models.attention")
    ssm_mod = importlib.import_module("repro_torch.models.ssm")
    smoke = chip_smoke()

    class Mark(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, name):
            ctx.name = name
            return t.view_as(t)

        @staticmethod
        def backward(ctx, grad):
            counts[ctx.name] += 1
            return grad, None

    def counted(name, first_of_tuple):
        def wrap(fn):
            def run(*args, **kw):
                counts[name] += 1
                out = fn(*args, **kw)
                t = out[0] if first_of_tuple else out
                if t.requires_grad:
                    t = Mark.apply(t, f"{name}_bwd")
                return (t,) + tuple(out[1:]) if first_of_tuple else t
            return run
        return wrap
    for name in ("flash_attention", "flash_attention_bwd", "ssd", "ssd_bwd"):
        counts.setdefault(name, 0)
    with smoke.patched(attn_mod, "_prefill_core",
                       counted("flash_attention", False)), \
            smoke.patched(ssm_mod, "ssd", counted("ssd", True)):
        yield


def train_case(mesh, case: dict) -> dict:
    """One sharded train step (``build_train_step(..., mesh=)``) of
    ``case["cfg"]`` on this rank: the state's shards cut from
    ``case["params"]`` (the whole tree; its dtype is the case's) with zero
    moments, the step on ``case["batch"]`` (numpy, the global batch) with
    ``case["zero1"]``, under the planted fault ``case["fault"]`` (one of
    ``chip_smoke.TRAIN_FAULTS`` or of the families' train faults) when
    given, its step built under it. A case with ``case["routes"]`` (by the
    size of the data axis, ``microbatch_routes``' record of the reference's
    step) feeds its MoE layers those top-k experts at this data rank's rows
    of each microbatch. Returns, fp32 numpy by path: the gradient shards
    the sharded AdamW took, the parameter shards before and after, the
    moment shards after; the loss, the norm, the coordinates and the
    step's all_reduce calls, and the calls the card's kernels would
    launch (``counting_cores``). With ``case["zero3"]`` the state is the
    rank's ZeRO-3 regions and the step ZeRO-3's; ``state_bytes`` are the
    bytes of the state the rank held before the step."""
    from repro_torch.models import build_model
    from repro_torch.models.param import shard_params, tree_items
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import train_lib
    smoke = chip_smoke()
    model = build_model(case["cfg"])
    opt = AdamWConfig(**case["opt"])
    zero1, zero3 = case["zero1"], case.get("zero3", False)
    specs = train_lib.make_train_state_specs(model, mesh, zero1=zero1,
                                             zero3=zero3)
    state = train_lib.init_train_state(model, opt, device="cpu", mesh=mesh,
                                       zero1=zero1, zero3=zero3)
    state = train_lib.TrainState(
        shard_params(case["params"], specs.params, mesh), state.opt)
    state_bytes = sum(a.numel() * a.element_size()
                      for tree in (state.params, state.opt.m, state.opt.v)
                      for _, a in tree_items(tree))
    # copies: an fp32 leaf's .float() is the leaf, stepped in place
    p0 = {"/".join(p): a.float().numpy().copy()
          for p, a in tree_items(state.params)}
    seen = {}

    def capture(update):
        def recording(params, grads, opt_state, opt_cfg, plan):
            seen.update({"/".join(p): g.float().numpy().copy()
                         for p, g in tree_items(grads)})
            return update(params, grads, opt_state, opt_cfg, plan)
        return recording
    batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
    count, kernels = [0], {}
    fault = case.get("fault")
    routes = fed_routes(case, mesh, batch["tokens"].shape[0],
                        model.cfg.microbatches)
    with smoke.train_faults(torch, fault, mesh) if fault \
            else contextlib.nullcontext():
        step = train_lib.build_train_step(model, opt, mesh=mesh, zero1=zero1,
                                          zero3=zero3)
        with smoke.patched(train_lib, "adamw_update_sharded", capture), \
                smoke.counting_all_reduce(torch, count), routes, \
                counting_cores(kernels):
            state, metrics = step(state, batch)

    def flat(tree):
        return {"/".join(p): a.float().numpy() for p, a in tree_items(tree)}
    return {"coords": dict(mesh.coords), "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "grads": seen,
            "p0": p0, "p1": flat(state.params), "m": flat(state.opt.m),
            "v": flat(state.opt.v), "collectives": count[0],
            "kernels": kernels, "state_bytes": state_bytes}


def train_loop_case(mesh, case: dict) -> dict:
    """``launch/train.py::train_loop`` of ``case["arch"]``, reduced, on the
    CPU, from this rank of the process group at the mesh's shape: 2 steps
    of 8 x 16 tokens in ``case["mu"]`` microbatches; a case with
    ``case["routes"]`` feeds its MoE layers as ``train_case`` does. Returns
    its losses."""
    from repro_torch.launch.train import train_loop
    with fed_routes(case, mesh, 8, case["mu"]):
        out = train_loop(case["arch"], reduced=True, device="cpu", steps=2,
                         batch=8, seq=16, microbatches=case["mu"],
                         log_every=0, data=mesh.shape["data"],
                         model=mesh.shape["model"])
    return {"losses": out["losses"]}


def leaf_bits(t: torch.Tensor):
    """A leaf's raw bits as numpy (bf16 as uint16), for an exact
    comparison."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("uint16")
    return t.numpy().copy()


def _ckpt_setup(mesh, case: dict, zero1: bool):
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import train_lib
    model = build_model(case["cfg"])
    opt = AdamWConfig(**case["opt"])
    zero3 = case.get("zero3", False)
    specs = train_lib.make_train_state_specs(model, mesh, zero1=zero1,
                                             zero3=zero3)
    state = train_lib.init_train_state(model, opt, device="cpu", mesh=mesh,
                                       zero1=zero1, zero3=zero3)
    return model, opt, specs, state


def _wait_for_save(directory: str, seconds: float = 240.0) -> None:
    """Until ``directory``'s step 1 is renamed into place (a save by
    another group of ranks), or raise."""
    import pathlib
    import time
    done = pathlib.Path(directory) / "step_00000001" / "manifest.json"
    deadline = time.monotonic() + seconds
    while not done.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no save in {directory}")
        time.sleep(0.2)


def ckpt_save_case(mesh, case: dict) -> dict:
    """One sharded train step of ``case["cfg"]`` from ``case["params"]``
    (the whole tree) and zero moments on ``case["batch"]``, then
    ``save_state(case["dir"], 1, ...)`` of this rank's shards over the
    mesh (with ``case["zero3"]``, its ZeRO-3 regions). Returns the
    coordinates and the bits of each shard after the step, by the
    checkpoint's key."""
    from repro_torch.checkpoint import save_state
    from repro_torch.models.param import shard_params, tree_items
    from repro_torch.runtime import train_lib
    model, opt, specs, state = _ckpt_setup(mesh, case, False)
    state = train_lib.TrainState(
        shard_params(case["params"], specs.params, mesh), state.opt)
    step = train_lib.build_train_step(model, opt, mesh=mesh,
                                      zero3=case.get("zero3", False))
    state, _ = step(state, {k: torch.as_tensor(v)
                            for k, v in case["batch"].items()})
    save_state(case["dir"], 1, state, specs=specs, mesh=mesh)
    return {"coords": dict(mesh.coords),
            "shards": {"__".join(p): leaf_bits(a)
                       for p, a in tree_items(state)}}


def ckpt_restore_case(mesh, case: dict) -> dict:
    """``restore_state(case["dir"], 1, ...)`` into this rank's shards of
    a fresh state under ZeRO-1 when ``case["zero1"]`` (its ZeRO-3 regions
    when ``case["zero3"]``; under ``chip_smoke.ckpt_fault`` when
    ``case["fault"]``), once the save is in place (``case["wait"]``: it
    may come from a group that runs beside this one). Returns the
    coordinates and the restored shards' bits by key."""
    from repro_torch.checkpoint import restore_state
    from repro_torch.models.param import tree_items
    if case.get("wait"):
        _wait_for_save(case["dir"])
    _, _, specs, state = _ckpt_setup(mesh, case, case["zero1"])
    with chip_smoke().ckpt_fault(torch) if case.get("fault") \
            else contextlib.nullcontext():
        state = restore_state(case["dir"], 1, state, specs=specs, mesh=mesh)
    return {"coords": dict(mesh.coords),
            "shards": {"__".join(p): leaf_bits(a)
                       for p, a in tree_items(state)}}


def ckpt_loop_case(mesh, case: dict) -> dict:
    """``train_loop`` of ``case["arch"]``, reduced, on the CPU over the
    mesh, 4 steps of 8 x 16 tokens: uninterrupted; then checkpointed every
    step into ``case["dir"]`` (every rank's) until the failure simulated
    after step 2; then resumed from that directory. Returns the three
    runs' losses and the resumed run's first step."""
    from repro_torch.launch.train import train_loop
    kw = dict(reduced=True, device="cpu", steps=4, batch=8, seq=16,
              log_every=0, data=mesh.shape["data"],
              model=mesh.shape["model"])
    whole = train_loop(case["arch"], **kw)
    try:
        train_loop(case["arch"], ckpt_dir=case["dir"], ckpt_every=1,
                   simulate_failure=2, **kw)
        raise AssertionError("the simulated failure did not happen")
    except RuntimeError as exc:
        if "simulated node failure" not in str(exc):
            raise
    resumed = train_loop(case["arch"], ckpt_dir=case["dir"], ckpt_every=1,
                         resume=True, **kw)
    return {"whole": whole["losses"], "resumed": resumed["losses"],
            "start_step": resumed["start_step"]}


def run_rank(rank: int, data: int, model: int, init_file: str,
             cases: dict, queue) -> None:
    """Rank ``rank`` of a ``data`` x ``model`` gloo group: every case, then
    ``(rank, results or the traceback)`` on ``queue``."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                world_size=data * model, rank=rank)
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(data, model, device_type="cpu")
        results = {"coords": dict(mesh.coords)}
        results.update({name: serve_case(mesh, case)
                        for name, case in cases.items()})
        queue.put((rank, results))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
