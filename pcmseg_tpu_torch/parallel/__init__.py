"""Data parallelism across processes on ``torch.distributed``: the port of
``pcmseg_tpu/parallel/``. One process per card; ``multihost`` starts the
process group and gives each process its share of the cases,
``sharding`` holds the ('data', 'spatial', 'model') mesh over the ranks
and the rows of a global batch each rank trains, and ``collectives`` the
all-reductions that GSPMD inserted in JAX (global loss and BatchNorm sums,
the gradient all-reduce, the exact exchange of disjoint rows)."""
