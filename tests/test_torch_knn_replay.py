"""Replaying a saved disagreement of the KNN kernel on the CPU: a case file
as ``chip_smoke.py:check_knn_equal`` writes it (``knn_cases.save_knn_failure``;
here a synthetic one whose "kernel" rows are corrupted) goes through the
kernel's schedule model and the plain version, which agree with each other
and say that the stored kernel output is the wrong side."""
import numpy as np
import torch

from test_torch_knn import model_knn_top3, points_per_lane
from relightableavatar_tpu_torch.eval.knn_cases import (cloud_sha256, load_knn_failure,
                                                        save_knn_failure, synthetic_points)
from relightableavatar_tpu_torch.ops.knn import knn_top3_reference

SMS = 132                   # the H100's streaming multiprocessors: the kernel's R choice


def test_saved_knn_failure_replays_through_the_model_and_the_plain_version(tmp_path):
    rng = np.random.default_rng(0)
    verts = torch.as_tensor(rng.normal(0, 0.3, (700, 3)).astype(np.float32))
    pts = synthetic_points(verts, 33, rng)
    d2r, ir = knn_top3_reference(pts, verts)
    d2k, ik = d2r.clone(), ir.clone()
    ik[[3, 17], 2] = ir[[3, 17], 2] + 1             # the disagreement: 2 points' 3rd neighbour
    d2k[[3, 17], 2] = d2r[[3, 17], 2] + 2.883e-04
    path = save_knn_failure("P=33", pts, verts, d2k, ik, d2r, ir, out_dir=str(tmp_path))
    assert path.endswith("knn_fail_P=33.npz")

    case = load_knn_failure(path)
    assert case["case"] == "P=33" and case["verts_sha256"] == cloud_sha256(verts.numpy())
    rd2, ridx = knn_top3_reference(torch.as_tensor(case["pts"]), torch.as_tensor(case["verts"]))
    assert np.array_equal(rd2.numpy(), case["plain_d2"])
    assert np.array_equal(ridx.numpy(), case["plain_idx"])
    for seed in range(3):
        md2, midx, stats = model_knn_top3(case["pts"], case["verts"],
                                          points_per_lane(len(case["pts"]), SMS),
                                          chunk_owner_seed=seed)
        assert stats["filter_misses"] == 0
        assert np.array_equal(md2, case["plain_d2"]) and np.array_equal(midx, case["plain_idx"])
    wrong = np.flatnonzero((case["kernel_idx"] != case["plain_idx"]).any(1))
    assert wrong.tolist() == [3, 17]
