"""Device time a step of the NCCL all-reduce kernels (the flat gradient
all-reduce of ``parallel/mesh.py`` and the losses' sums); it includes the
wait for the slowest rank, since a rank's kernel runs until every rank has
joined."""


def read(rec):
    if rec["allreduce_s"] <= 0:
        return None
    return 1e3 * rec["allreduce_s"] / rec["units"]
