"""Paper benchmark workflows (Table 3): WC, FP, Cyc, Epi, Gen, Soy.

The originals come from FaaSFlow's benchmark suite and the Pegasus
scientific-workflow gallery.  We regenerate the same DAG *shapes* (stage
structure, fan-out, >40 functions for the scientific apps, >50 for Genome)
with deterministic execution times and output sizes in the ranges the paper
reports ("the output of a single function is at most tens of MB", §4).

Each generator returns a :class:`~repro.core.dag.Workflow`; exec times and
sizes are seeded by a simple LCG so every run of every experiment sees the
exact same workload.

Copy of ``repro/core/workloads.py`` for the PyTorch port, which imports
nothing of ``repro``; its code is the reference's, line for line, with no
departure.
"""

from __future__ import annotations

from .dag import FunctionSpec, Workflow

__all__ = ["BENCHMARKS", "make_workflow", "wordcount", "file_processing",
           "cycles", "epigenomics", "genome", "soykb",
           "wordcount_large", "genome_large",
           "serving_chain", "serving_fanout"]

MB = 1 << 20


class _Det:
    """Tiny deterministic LCG so workloads never depend on global RNG."""

    def __init__(self, seed: int):
        self.s = (seed * 2654435761 + 0x9E3779B9) & 0xFFFFFFFF

    def next(self) -> float:
        self.s = (1103515245 * self.s + 12345) & 0x7FFFFFFF
        return self.s / 0x7FFFFFFF

    def uniform(self, lo: float, hi: float) -> float:
        return lo + (hi - lo) * self.next()


def _fn(name, inputs, outputs, t, sizes, cpu=1.0):
    return FunctionSpec(name=name, inputs=tuple(inputs),
                        outputs=tuple(outputs), exec_time=t,
                        output_sizes=sizes, cpu=cpu)


# ----------------------------------------------------------------------
def wordcount(shards: int = 16) -> Workflow:
    """WC: split -> count.{i} -> merge (map/reduce, real-world app)."""
    rng = _Det(101)
    fns = [_fn("split", ["corpus"], [f"shard.{i}" for i in range(shards)],
               0.6, {f"shard.{i}": int(3 * MB) for i in range(shards)})]
    for i in range(shards):
        fns.append(_fn(f"count.{i}", [f"shard.{i}"], [f"wc.{i}"],
                       rng.uniform(0.5, 1.2), {f"wc.{i}": int(1 * MB)}))
    fns.append(_fn("merge", [f"wc.{i}" for i in range(shards)], ["result"],
                   0.8, {"result": int(1 * MB)}))
    return Workflow("WC", fns, {"corpus": int(32 * MB)})


def file_processing(files: int = 8) -> Workflow:
    """FP: per-file chains (extract->transform->compress) then archive."""
    rng = _Det(202)
    fns = [_fn("index", ["bundle"], [f"file.{i}" for i in range(files)],
               0.5, {f"file.{i}": int(4 * MB) for i in range(files)})]
    for i in range(files):
        fns.append(_fn(f"extract.{i}", [f"file.{i}"], [f"raw.{i}"],
                       rng.uniform(0.4, 0.9), {f"raw.{i}": int(5 * MB)}))
        fns.append(_fn(f"transform.{i}", [f"raw.{i}"], [f"tf.{i}"],
                       rng.uniform(0.8, 1.6), {f"tf.{i}": int(4 * MB)}))
        fns.append(_fn(f"compress.{i}", [f"tf.{i}"], [f"zip.{i}"],
                       rng.uniform(0.5, 1.0), {f"zip.{i}": int(2 * MB)}))
    fns.append(_fn("archive", [f"zip.{i}" for i in range(files)],
                   ["archive"], 0.9, {"archive": int(8 * MB)}))
    return Workflow("FP", fns, {"bundle": int(24 * MB)})


def cycles(crops: int = 12) -> Workflow:
    """Cyc: Pegasus Cycles (agroecosystem) — widest data exchange.

    Per-crop chain of 3 simulations feeding a cross-crop analysis layer and
    a summarizing tail.  40+ functions, large outputs (the paper's only
    CFlow timeout at 50 MB/s is Cyc — data volume dominates).
    """
    rng = _Det(303)
    fns = [_fn("prepare", ["params"],
               [f"soil.{i}" for i in range(crops)], 0.7,
               {f"soil.{i}": int(6 * MB) for i in range(crops)})]
    for i in range(crops):
        fns.append(_fn(f"baseline.{i}", [f"soil.{i}"], [f"base.{i}"],
                       rng.uniform(1.2, 2.2), {f"base.{i}": int(14 * MB)}))
        fns.append(_fn(f"cycles.{i}", [f"base.{i}"], [f"cyc.{i}"],
                       rng.uniform(1.5, 2.8), {f"cyc.{i}": int(16 * MB)}))
        fns.append(_fn(f"fertilizer.{i}", [f"cyc.{i}"], [f"fert.{i}"],
                       rng.uniform(1.0, 2.0), {f"fert.{i}": int(10 * MB)}))
    for j in range(4):
        ins = [f"fert.{i}" for i in range(crops) if i % 4 == j]
        fns.append(_fn(f"analysis.{j}", ins, [f"ana.{j}"],
                       rng.uniform(1.2, 2.0), {f"ana.{j}": int(6 * MB)}))
    fns.append(_fn("summarize", [f"ana.{j}" for j in range(4)], ["summary"],
                   1.0, {"summary": int(4 * MB)}))
    fns.append(_fn("visualize", ["summary"], ["plots"], 0.8,
                   {"plots": int(6 * MB)}))
    return Workflow("Cyc", fns, {"params": int(2 * MB)})


def epigenomics(lanes: int = 12) -> Workflow:
    """Epi: Pegasus Epigenomics — deep per-lane chains then merge tail."""
    rng = _Det(404)
    fns = [_fn("fastq_split", ["fastq"],
               [f"chunk.{i}" for i in range(lanes)], 0.8,
               {f"chunk.{i}": int(3 * MB) for i in range(lanes)})]
    for i in range(lanes):
        fns.append(_fn(f"filter.{i}", [f"chunk.{i}"], [f"filt.{i}"],
                       rng.uniform(0.6, 1.2), {f"filt.{i}": int(3 * MB)}))
        fns.append(_fn(f"sol2sanger.{i}", [f"filt.{i}"], [f"sang.{i}"],
                       rng.uniform(0.4, 0.8), {f"sang.{i}": int(3 * MB)}))
        fns.append(_fn(f"fastq2bfq.{i}", [f"sang.{i}"], [f"bfq.{i}"],
                       rng.uniform(0.4, 0.8), {f"bfq.{i}": int(2 * MB)}))
        fns.append(_fn(f"map.{i}", [f"bfq.{i}", "ref_genome"], [f"bam.{i}"],
                       rng.uniform(1.4, 2.4), {f"bam.{i}": int(4 * MB)}))
    fns.append(_fn("map_merge", [f"bam.{i}" for i in range(lanes)],
                   ["merged"], 1.2, {"merged": int(10 * MB)}))
    fns.append(_fn("maq_index", ["merged"], ["index"], 0.9,
                   {"index": int(4 * MB)}))
    fns.append(_fn("pileup", ["index"], ["pileup"], 1.1,
                   {"pileup": int(4 * MB)}))
    return Workflow("Epi", fns, {"fastq": int(40 * MB),
                                 "ref_genome": int(8 * MB)})


def genome(individuals: int = 30, analyses: int = 20) -> Workflow:
    """Gen: 1000Genome — >50 functions (§5.2), large exchanged data."""
    rng = _Det(505)
    fns = []
    for i in range(individuals):
        fns.append(_fn(f"individuals.{i}", ["chromosome"], [f"ind.{i}"],
                       rng.uniform(1.0, 2.0), {f"ind.{i}": int(2 * MB)}))
    fns.append(_fn("individuals_merge", [f"ind.{i}" for i in range(individuals)],
                   ["merged_ind"], 1.6, {"merged_ind": int(4 * MB)}))
    fns.append(_fn("sifting", ["chromosome"], ["sifted"], 1.2,
                   {"sifted": int(2 * MB)}))
    half = analyses // 2
    for j in range(half):
        fns.append(_fn(f"mutation_overlap.{j}", ["merged_ind", "sifted"],
                       [f"mut.{j}"], rng.uniform(1.0, 1.8),
                       {f"mut.{j}": int(1 * MB)}))
    for j in range(analyses - half):
        fns.append(_fn(f"frequency.{j}", ["merged_ind", "sifted"],
                       [f"freq.{j}"], rng.uniform(1.2, 2.0),
                       {f"freq.{j}": int(1 * MB)}))
    fns.append(_fn("report", [f"mut.{j}" for j in range(half)] +
                   [f"freq.{j}" for j in range(analyses - half)],
                   ["report"], 0.9, {"report": int(1 * MB)}))
    return Workflow("Gen", fns, {"chromosome": int(16 * MB)})


def soykb(samples: int = 7, chromosomes: int = 4) -> Workflow:
    """Soy: Pegasus SoyKB — deep per-sample chains + joint genotyping."""
    rng = _Det(606)
    fns = []
    stages = ["align", "sort", "dedup", "add_rg", "realign", "haplotype"]
    for i in range(samples):
        prev_key = "reads"
        for s, stage in enumerate(stages):
            out = f"{stage}.{i}"
            fns.append(_fn(f"{stage}.{i}", [prev_key], [out],
                           rng.uniform(0.7, 1.5), {out: int(3 * MB)}))
            prev_key = out
    gvcfs = [f"haplotype.{i}" for i in range(samples)]
    for c in range(chromosomes):
        fns.append(_fn(f"genotype.{c}", gvcfs, [f"geno.{c}"],
                       rng.uniform(1.2, 2.2), {f"geno.{c}": int(3 * MB)}))
    fns.append(_fn("combine", [f"geno.{c}" for c in range(chromosomes)],
                   ["combined"], 1.0, {"combined": int(5 * MB)}))
    fns.append(_fn("filtering", ["combined"], ["filtered"], 0.8,
                   {"filtered": int(3 * MB)}))
    fns.append(_fn("merge", ["filtered"], ["final"], 0.6,
                   {"final": int(2 * MB)}))
    return Workflow("Soy", fns, {"reads": int(20 * MB)})


# ----------------------------------------------------------------------
# DStream stress variants: same DAG shapes, output sizes scaled so every
# edge carries many stream chunks (SimConfig.stream_chunk defaults to 1 MB)
# and inter-node transfer time rivals execution time — the regime where
# chunked pipelining (overlap of production and transfer) has headroom.

def wordcount_large(shards: int = 8) -> Workflow:
    """WC-L: map/reduce with tens-of-MB shards (chunk-aware WC variant)."""
    rng = _Det(707)
    fns = [_fn("split", ["corpus"], [f"shard.{i}" for i in range(shards)],
               1.2, {f"shard.{i}": int(24 * MB) for i in range(shards)})]
    for i in range(shards):
        fns.append(_fn(f"count.{i}", [f"shard.{i}"], [f"wc.{i}"],
                       rng.uniform(0.8, 1.6), {f"wc.{i}": int(12 * MB)}))
    fns.append(_fn("merge", [f"wc.{i}" for i in range(shards)], ["result"],
                   1.0, {"result": int(8 * MB)}))
    return Workflow("WC-L", fns, {"corpus": int(64 * MB)})


def genome_large(individuals: int = 12, analyses: int = 8) -> Workflow:
    """Gen-L: 1000Genome with a fat shared intermediate (chunk-aware).

    ``merged_ind`` (32 MB) fans out to every analysis function, so the
    monolithic plane serialises a long transfer per remote consumer while
    DStream starts every consumer on chunk 0 during the merge."""
    rng = _Det(808)
    fns = []
    for i in range(individuals):
        fns.append(_fn(f"individuals.{i}", ["chromosome"], [f"ind.{i}"],
                       rng.uniform(1.0, 2.0), {f"ind.{i}": int(8 * MB)}))
    fns.append(_fn("individuals_merge",
                   [f"ind.{i}" for i in range(individuals)],
                   ["merged_ind"], 2.0, {"merged_ind": int(32 * MB)}))
    fns.append(_fn("sifting", ["chromosome"], ["sifted"], 1.4,
                   {"sifted": int(16 * MB)}))
    half = analyses // 2
    for j in range(half):
        fns.append(_fn(f"mutation_overlap.{j}", ["merged_ind", "sifted"],
                       [f"mut.{j}"], rng.uniform(1.0, 1.8),
                       {f"mut.{j}": int(4 * MB)}))
    for j in range(analyses - half):
        fns.append(_fn(f"frequency.{j}", ["merged_ind", "sifted"],
                       [f"freq.{j}"], rng.uniform(1.2, 2.0),
                       {f"freq.{j}": int(4 * MB)}))
    fns.append(_fn("report", [f"mut.{j}" for j in range(half)] +
                   [f"freq.{j}" for j in range(analyses - half)],
                   ["report"], 1.0, {"report": int(2 * MB)}))
    return Workflow("Gen-L", fns, {"chromosome": int(32 * MB)})


# ----------------------------------------------------------------------
# Serving workloads: small request-scale DAGs with *real callables* so the
# threaded DServe layer (repro.core.serve) can execute them end-to-end.
# Execution sleeps `exec_time` and emits a deterministic digest-derived
# payload, so differential/serving tests can assert exact bytes while the
# container-pool dynamics (cold boot vs prewarm) stay observable.

def _digest_fn(out_key: str, exec_time: float, payload: int):
    import hashlib
    import time as _time

    def fn(**kw):
        if exec_time:
            _time.sleep(exec_time)
        h = hashlib.sha256(out_key.encode())
        for k in sorted(kw):
            v = kw[k]
            h.update(k.encode())
            h.update(v if isinstance(v, (bytes, bytearray))
                     else repr(v).encode())
        d = h.digest()
        return {out_key: (d * (payload // len(d) + 1))[:payload]}
    return fn


def serving_chain(stages: int = 4, *, exec_time: float = 0.03,
                  cold_start: float = 0.12,
                  payload: int = 64 * 1024) -> Workflow:
    """Srv: a latency-sensitive request pipeline (stage0 -> ... -> stageN).

    The worst case for controlflow cold starts: every stage's container
    boot sits on the critical path unless it was prewarmed when its
    precursor launched (paper §3.2)."""
    fns = []
    prev = "request"
    for i in range(stages):
        out = f"s{i}"
        fns.append(FunctionSpec(
            f"stage{i}", inputs=(prev,), outputs=(out,),
            fn=_digest_fn(out, exec_time, payload), exec_time=exec_time,
            output_sizes={out: payload}, cold_start=cold_start))
        prev = out
    return Workflow("Srv", fns, {"request": 1024})


def serving_fanout(workers: int = 4, *, exec_time: float = 0.03,
                   cold_start: float = 0.12,
                   payload: int = 32 * 1024) -> Workflow:
    """SrvF: scatter/gather request shape (route -> worker.{i} -> merge)."""
    fns = [FunctionSpec(
        "route", inputs=("request",),
        outputs=tuple(f"part.{i}" for i in range(workers)),
        fn=_digest_multi(
            [f"part.{i}" for i in range(workers)], exec_time, payload),
        exec_time=exec_time,
        output_sizes={f"part.{i}": payload for i in range(workers)},
        cold_start=cold_start)]
    for i in range(workers):
        fns.append(FunctionSpec(
            f"worker.{i}", inputs=(f"part.{i}",), outputs=(f"res.{i}",),
            fn=_digest_fn(f"res.{i}", exec_time, payload),
            exec_time=exec_time, output_sizes={f"res.{i}": payload},
            cold_start=cold_start))
    fns.append(FunctionSpec(
        "merge", inputs=tuple(f"res.{i}" for i in range(workers)),
        outputs=("response",),
        fn=_digest_fn("response", exec_time, payload),
        exec_time=exec_time, output_sizes={"response": payload},
        cold_start=cold_start))
    return Workflow("SrvF", fns, {"request": 1024})


def _digest_multi(out_keys: list[str], exec_time: float, payload: int):
    fns = {k: _digest_fn(k, 0.0, payload) for k in out_keys}
    import time as _time

    def fn(**kw):
        if exec_time:
            _time.sleep(exec_time)
        out = {}
        for k, f in fns.items():
            out.update(f(**kw))
        return out
    return fn


BENCHMARKS = {
    "WC": wordcount,
    "FP": file_processing,
    "Cyc": cycles,
    "Epi": epigenomics,
    "Gen": genome,
    "Soy": soykb,
    "WC-L": wordcount_large,
    "Gen-L": genome_large,
    "Srv": serving_chain,
    "SrvF": serving_fanout,
}


def make_workflow(name: str) -> Workflow:
    return BENCHMARKS[name]()
