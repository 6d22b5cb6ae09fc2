"""Multi-host runtime skeleton (SURVEY.md §5 distributed-backend row).

The reference is single-host; this framework scales across hosts with
jax.distributed: every process calls :func:`init_distributed`, builds the
same global ("reads",) mesh over all devices, feeds its local read shard into
:func:`distributed_node_abundances`, and XLA's psums merge the coverage
across devices and hosts.  Coverage contributions are integer-valued, so the merged outputs
are bit-identical to a single-process run (tests/test_distributed.py proves
this on a 2-process CPU mesh).
"""
from __future__ import annotations

import numpy as np

import jax


def init_distributed(coordinator: str, num_processes: int, process_id: int) -> None:
    """jax.distributed.initialize wrapper.  CPU-mesh processes control their
    local device count via --xla_force_host_platform_device_count."""
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def local_read_shard(path):
    """Stream this process's record-aligned shard of ONE shared FASTA/FASTQ
    path (the DCN streaming loader, SURVEY.md §5): every host passes the same
    file; host i seeks to its byte range and reads only the records starting
    there, so the fleet collectively consumes each record exactly once with
    no pre-splitting.  Yields (read_id, seq) records."""
    from ..io.fastx import iter_fastx_shard

    return iter_fastx_shard(path, jax.process_index(), jax.process_count())


def global_reads_mesh():
    """1-D ("reads",) mesh over every chip of every host."""
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()).reshape(-1), ("reads", ))


def _process_mesh():
    """1-D ("p",) mesh with ONE device per process (device i addressable by
    process i), for cross-process reductions of per-process values."""
    from jax.sharding import Mesh

    per_proc: dict[int, object] = {}
    for d in jax.devices():
        per_proc.setdefault(d.process_index, d)
    n = jax.process_count()
    return Mesh(np.array([per_proc[i] for i in range(n)]), ("p",))


_JIT_CACHE: dict = {}


def _jit_gather(mesh):
    """Cached jit identity with replicated out_sharding (= all-gather).
    A fresh jax.jit(lambda ...) per call would recompile every time."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    key = ("gather", tuple(d.id for d in mesh.devices.flat))
    fn = _JIT_CACHE.get(key)
    if fn is None:
        fn = jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))
        _JIT_CACHE[key] = fn
    return fn


def _jit_psum(mesh):
    """Cached jit sum-over-process-axis with replicated out_sharding
    (= all-reduce)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    key = ("psum", tuple(d.id for d in mesh.devices.flat))
    fn = _JIT_CACHE.get(key)
    if fn is None:
        fn = jax.jit(lambda x: x.sum(axis=0, dtype=x.dtype),
                     out_shardings=NamedSharding(mesh, P()))
        _JIT_CACHE[key] = fn
    return fn


def _allgather_rows(local_row: np.ndarray, mesh=None) -> np.ndarray:
    """All-gather one fixed-shape row per process -> [P, ...] on every
    process (jit identity with a replicated out_sharding lowers to an
    all-gather over the process mesh)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = mesh or _process_mesh()
    n = jax.process_count()
    g = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("p")), local_row[None],
        (n,) + local_row.shape,
    )
    out = _jit_gather(mesh)(g)
    return np.asarray(out)


def cross_process_sum(arrs):
    """Element-wise sum of per-process arrays across all processes; every
    process receives the full merged result (numpy).  Used to merge the
    fused pipeline's coverage accumulators — integer-valued addends, so the
    merge is exact and process-count-invariant."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = _process_mesh()
    n = jax.process_count()
    out = []
    for a in arrs:
        loc = np.asarray(a)
        g = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P("p")), loc[None], (n,) + loc.shape
        )
        s = _jit_psum(mesh)(g)
        out.append(np.asarray(s))
    return tuple(out)


def gather_read_rows(reads: dict) -> dict:
    """Concatenate every process's per-read columns (the FusedPipeline
    finish() dict: mapq/aligned/ridx/read_len + optional ids) in PROCESS
    order on every process.  With byte-range read sharding
    (shard_fastx_buffers), process order == file order, so the gathered
    arrays are bit-identical to a single-process run over the whole file.
    Strings travel as one newline-joined uint8 buffer per process."""
    mesh = _process_mesh()
    counts = _allgather_rows(
        np.array([len(reads["mapq"])], dtype=np.int64), mesh
    )[:, 0]
    n_max = int(counts.max()) if len(counts) else 0
    out: dict = {}
    for k in ("mapq", "aligned", "ridx", "read_len"):
        col = np.asarray(reads[k])
        pad = np.zeros(n_max, dtype=col.dtype)
        pad[: len(col)] = col
        g = _allgather_rows(pad, mesh)
        out[k] = np.concatenate([g[i, : counts[i]] for i in range(len(counts))])
    ids = reads.get("ids")
    if ids is not None:
        blob = "\n".join(ids).encode()
        blen = _allgather_rows(
            np.array([len(blob)], dtype=np.int64), mesh
        )[:, 0]
        b_max = int(blen.max()) if len(blen) else 0
        pad = np.zeros(b_max, dtype=np.uint8)
        pad[: len(blob)] = np.frombuffer(blob, dtype=np.uint8)
        g = _allgather_rows(pad, mesh)
        out_ids: list[str] = []
        for i in range(len(blen)):
            if blen[i]:
                out_ids.extend(
                    g[i, : blen[i]].tobytes().decode().split("\n")
                )
        out["ids"] = out_ids
    else:
        out["ids"] = None
    return out


def distributed_node_abundances(packed_local, nodes_len, trio_index,
                                mesh=None):
    """Full-parity coverage over a multi-process read shard.

    Every process passes its own PackedReads (equal padded shapes across
    processes — pad the read count to processes x pow2 beforehand); graph
    tables are replicated.  Returns the globally merged
    (node_abundance, trio_abundance, node_base_cov) on every process.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops.coverage_device import build_padded_tables, sharded_node_abundances

    mesh = mesh or global_reads_mesh()
    n_proc = jax.process_count()
    t = build_padded_tables(nodes_len, trio_index.trio_nodes, trio_index.trio_len)

    R, L = packed_local.nodes.shape
    L_pad = max(4, 1 << (L - 1).bit_length())
    n_dev = int(mesh.devices.size)
    per_dev = -(-R // (n_dev // n_proc))
    R_pad_local = per_dev * (n_dev // n_proc)
    R_global = R_pad_local * n_proc

    def pad2(a, fill, dtype):
        out = np.full((R_pad_local, L_pad), fill, dtype=dtype)
        out[:R, :L] = a
        return out

    def pad1(a, dtype):
        out = np.zeros(R_pad_local, dtype=dtype)
        out[:R] = a
        return out

    reads_sh = NamedSharding(mesh, P("reads"))
    repl = NamedSharding(mesh, P())

    def gput(local, global_shape):
        return jax.make_array_from_process_local_data(
            reads_sh, local, global_shape
        )

    nodes = gput(pad2(packed_local.nodes, -1, np.int32), (R_global, L_pad))
    lengths = gput(pad1(packed_local.lengths, np.int32), (R_global,))
    rs = gput(pad1(packed_local.read_start, np.int32), (R_global,))
    re = gput(pad1(packed_local.read_end, np.int32), (R_global,))
    tables = [
        jax.device_put(np.asarray(x), repl)
        for x in (t.nodes_len, t.base_offset,
                  t.trio_hash, t.trio_order, t.trio_abc, t.trio_len,
                  t.trio_bucket)
    ]
    fn = sharded_node_abundances(
        mesh, t.N_pad, t.TB_pad, t.U_pad,
        trio_bits=t.trio_bits, trio_steps=t.trio_steps,
        trio_probes=t.trio_probes,
    )
    na, ta, bc = fn(nodes, lengths, rs, re, *tables)
    N, U = t.N, t.U
    return (
        np.asarray(na, dtype=np.float64)[:N],
        np.asarray(ta, dtype=np.float64)[:U],
        np.asarray(bc)[:N],
    )
