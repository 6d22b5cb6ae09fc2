"""pantax_tpu — a JAX pangenome-graph strain-level metagenomic profiler.

A from-scratch JAX/XLA rebuild of the capabilities of PanTax
(LuoGroup2023/PanTax): per-species pangenome graphs, read-to-graph alignment,
species- and strain-level abundance estimation via Path Abundance Optimization.

Layer map (mirrors the reference's pipeline semantics, not its implementation):

  io/        FASTA/FASTQ/GFA/GAF parsing and report writers (host)
  graph/     species graph model, eq-1 chain builder, anchor-partition
             pangenome constructor, CSR tensor packing, DB layout
  align/     minimizer index + seed/vote + banded glocal DP extension,
             projection of linear alignments onto graph node paths
  profile/   read classification, species profiling, node/trio coverage
             (segment_sum), strain filters, PAO solver (ADMM), reports
  parallel/  jax.sharding mesh utilities and collectives
  db/        database construction/merge/preprocessing orchestration
  ops/       device coverage, fused align+coverage step, profile tail
  utils/     logging, timers, checkpoint/resume
"""

__version__ = "0.1.0"
