"""The port's start sequence from its own CLIs (after tests/test_cli.py):
`python -m gns_torch.utils` writes a data set, `python -m gns_torch.train
--cpu` trains from it and `python -m gns_torch.eval --cpu` evaluates the
checkpoint on the data set's held-out pickles, without gns_tpu; and the
new modules import neither jax nor gns_tpu."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np

from gns_torch.utils.augment import generate_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "best_model_c9_K2_L4_H4_True_optimAdam"


def run_cli(args, timeout=240):
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)


def test_generate_train_eval_from_the_port_cli(tmp_path):
    data_dir = str(tmp_path / "data")
    r = run_cli(["gns_torch.utils", "--case", "9", "--num", "8", "--seed", "1",
                 "--data-dir", data_dir])
    assert r.returncode == 0, r.stderr[-800:]
    assert f"wrote case9 dataset (8+1 grids) to {os.path.join(data_dir, 'case9')}" in r.stdout
    files = sorted(os.listdir(os.path.join(data_dir, "case9")))
    assert files == sorted(["prepared_case9.npz"] + [f"augmented_case9_{i}.pkl" for i in range(9)])

    r = run_cli(["gns_torch.train", "--cpu", "--case", "9", "--K", "2", "--latent", "4",
                 "--hidden", "4", "--epochs", "1", "--batch-size", "4", "--nr-samples", "8",
                 "--data-dir", data_dir, "--out-dir", str(tmp_path / "models"),
                 "--runs-dir", str(tmp_path / "runs")])
    assert r.returncode == 0, r.stderr[-800:]
    assert "loaded 8 case9 grids; device cpu" in r.stdout
    assert "done; best checkpoint" in r.stdout
    ckpt = tmp_path / "models" / f"{NAME}.pt"
    assert ckpt.exists() and (tmp_path / "runs" / f"{NAME}.csv").exists()

    r = run_cli(["gns_torch.eval", "--cpu", "--case", "9", "--K", "2", "--latent", "4",
                 "--hidden", "4", "--samples", "3", "--total-grids", "9",
                 "--data-dir", data_dir, "--checkpoint", str(ckpt),
                 "--plot", str(tmp_path / "p.png"), "--json-out", str(tmp_path / "m.json")])
    assert r.returncode == 0, r.stderr[-800:]
    assert "falling back" not in r.stdout
    assert "evaluating on 3 case9 grids; device cpu" in r.stdout
    m = json.loads((tmp_path / "m.json").read_text())
    assert "fallback_from_base_case" not in m
    assert np.isfinite(m["v_mse"]) and np.isfinite(m["theta_centered_mse"])
    # the held-out pickles are the generated grids 6..8
    want = list(generate_cases(9, 8, seed=1))[6:]
    for i, case in zip(range(6, 9), want):
        with open(os.path.join(data_dir, "case9", f"augmented_case9_{i}.pkl"), "rb") as f:
            got = pickle.load(f)
        for key in case:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(case[key]))


def test_no_pickles_trains_from_the_npz_and_eval_refuses(tmp_path):
    """--no-pickles writes only the npz: training reads it; evaluation,
    which needs the raw pickles for its oracle, raises instead of falling
    back onto other grids."""
    data_dir = str(tmp_path / "data")
    r = run_cli(["gns_torch.utils", "--case", "9", "--num", "8", "--seed", "2",
                 "--data-dir", data_dir, "--no-pickles"])
    assert r.returncode == 0, r.stderr[-800:]
    assert os.listdir(os.path.join(data_dir, "case9")) == ["prepared_case9.npz"]
    r = run_cli(["gns_torch.train", "--cpu", "--case", "9", "--K", "2", "--latent", "4",
                 "--hidden", "4", "--epochs", "1", "--batch-size", "4", "--nr-samples", "8",
                 "--data-dir", data_dir, "--out-dir", str(tmp_path / "models"),
                 "--runs-dir", str(tmp_path / "runs")])
    assert r.returncode == 0, r.stderr[-800:]
    assert "loaded 8 case9 grids" in r.stdout
    r = run_cli(["gns_torch.eval", "--cpu", "--case", "9", "--K", "2", "--latent", "4",
                 "--hidden", "4", "--samples", "3", "--total-grids", "9",
                 "--data-dir", data_dir, "--plot", str(tmp_path / "p.png")])
    assert r.returncode != 0
    assert "FileNotFoundError" in r.stderr


def test_new_modules_import_no_jax():
    """The data path's modules and the refresh import torch and numpy,
    never jax or gns_tpu."""
    code = (
        "import sys\n"
        "import gns_torch, gns_torch.utils, gns_torch.utils.native, gns_torch.utils.augment\n"
        "import gns_torch.utils.__main__, gns_torch.utils.schema, gns_torch.physics.fused\n"
        "import gns_torch.physics.common, gns_torch.train.__main__, gns_torch.eval.__main__\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'gns_tpu'))]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=240)
    assert r.returncode == 0, r.stderr[-800:]
    assert r.stdout.strip() == "clean"
