"""Kernel K1 (top-3 KNN, ``csrc/knn_top3.cu``) against its roofline: the
sum over the traced launches of each one's least time
(``flops.knn_bound_s`` of its points and vertices, as the recorder around
``ops/knn_cuda.KNN_TOP3`` saw them) over K1's device time in the trace."""

from portbench.flops import knn_bound_s


def read(rec):
    if not rec["knn_shapes"] or rec["knn_s"] <= 0 or not rec.get("peaks"):
        return None
    bound = sum(knn_bound_s(P, N, rec["peaks"]) for P, N in rec["knn_shapes"])
    return 100.0 * bound / rec["knn_s"]
