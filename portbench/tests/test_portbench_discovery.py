"""A cell, a configuration, a traffic mix and a metric added as new files
plus entries in BENCHMARK.json are found with no edit to a file that is
there, and what the new files say is what runs."""

import json
import os
import shutil

from _util import ROOT, small_cell


def test_added_files_are_found(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "mav_tube_trajectory_generation_tpu_torch"),
               root / "mav_tube_trajectory_generation_tpu_torch")
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "qcqp_admm_k10.json").read_text())
    cfg.update(name="qcqp_admm_k8", n_segments=8)
    cfg["admm"]["n_iters"] = 24
    (pb / "configs" / "qcqp_admm_k8.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / "admm_k10.json").read_text())
    tr["radii"] = {"kind": "constant", "value": 1.2}
    (pb / "traffic" / "wide.json").write_text(json.dumps(tr))
    shutil.copy(pb / "cells" / "admm_k10.json", pb / "cells" / "admm_k8_wide.json")
    (pb / "metrics" / "calls_in_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx.latencies_s)) or None\n")
    bench["configs"].append(dict(bench["configs"][0], name="qcqp_admm_k8",
                                 file="portbench/configs/qcqp_admm_k8.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="admm_k8_wide",
                                   config="qcqp_admm_k8", traffic="wide"))
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("admm_k8_wide")
    bench["end_to_end"].append({"name": "calls_in_window", "unit": "calls",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["admm_k8_wide"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    from mav_tube_trajectory_generation_tpu_torch.solver import qcqp
    from portbench import core
    cell = small_cell("admm_k8_wide", root=str(root))
    seen = []
    orig = qcqp.solve_qcqp_batch

    def solve(structure, d_fixed, times, waypoints, radii, config=None, **kw):
        seen.append((times.shape[1], round(float(radii.max()), 6),
                     config.n_iters))
        return orig(structure, d_fixed, times, waypoints, radii,
                    config=config, **kw)
    monkeypatch.setattr(qcqp, "solve_qcqp_batch", solve)
    out = core.run_cell(cell, 12345, 0.0, False, device="cpu", calls=2)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"solves_per_s", "batch_ms_p95", "setup_s",
                                   "calls_in_window"}
    assert out["metrics"]["calls_in_window"]["value"] == 2
    # the warm call and two calls, each with the new files' sizes
    assert seen == [(8, 1.2, 24)] * 3
