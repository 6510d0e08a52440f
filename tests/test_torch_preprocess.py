"""The port's preprocessing (``data/preprocess.py``, ``python -m
dr4sr_tpu_torch.scripts.preprocess``) against the JAX package's
(``dr4sr_tpu/data/preprocess.py``, ``scripts/preprocess.py``), on small raw
files written here from a seeded numpy generator. Every array must be
equal."""

import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from dr4sr_tpu.data import preprocess as jax_pre
from dr4sr_tpu_torch.data import preprocess
from dr4sr_tpu_torch.scripts import preprocess as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("train.npz", "val.npz", "test.npz", "meta.npz", "seq2pat_data.npz")


def _interactions(seed=0, users=40, items=30):
    """(user, item, rating, timestamp) rows: most users and items pass a
    5-core, some do not, so the filter iterates."""
    r = np.random.default_rng(seed)
    rows = []
    for u in range(users):
        n = int(r.integers(3, 14))
        its = r.choice(items, size=n, replace=False)
        ts = np.sort(r.choice(10_000, size=n, replace=False))
        rows += [(f"u{u}", f"i{i}", int(r.integers(1, 6)), int(t)) for i, t in zip(its, ts)]
    return pd.DataFrame(rows, columns=["user_id", "item_id", "rating", "timestamp"])


def _assert_frames_equal(got, want):
    pd.testing.assert_frame_equal(got.reset_index(drop=True), want.reset_index(drop=True))


@pytest.mark.parametrize("thresholds", [(5, 5), (3, 4), (8, 2)])
def test_core_filter_matches_jax(thresholds):
    df = _interactions()
    got = preprocess.core_filter(df, *thresholds)
    _assert_frames_equal(got, jax_pre.core_filter(df, *thresholds))
    assert (got["user_id"].value_counts() >= thresholds[0]).all()


def test_factorize_ids_matches_jax():
    df = preprocess.core_filter(_interactions(1))
    got, users, items = preprocess.factorize_ids(df)
    want, jusers, jitems = jax_pre.factorize_ids(df)
    _assert_frames_equal(got, want)
    assert (users, items) == (jusers, jitems)
    assert got["user_id"].min() == 1 and got["item_id"].max() == items - 1


def _assert_rows_equal(got, want):
    for field in ("user_id", "in_item_id", "item_id", "seqlen", "label", "domain_id"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    if want.user_hist is None:
        assert got.user_hist is None
    else:
        np.testing.assert_array_equal(got.user_hist, want.user_hist)


@pytest.mark.parametrize("max_seq_len, domain_idx", [(50, 0), (6, 1)])
def test_resplit_sequences_matches_jax(max_seq_len, domain_idx):
    r = np.random.default_rng(2)
    seqs = [list(r.integers(1, 40, size=r.integers(0, 12))) for _ in range(60)]
    got = preprocess.resplit_sequences(seqs, max_seq_len, domain_idx)
    want = jax_pre.resplit_sequences(seqs, max_seq_len, domain_idx)
    assert got[3:] == want[3:]
    for g, w in zip(got[:3], want[:3]):
        _assert_rows_equal(g, w)


# ---------------------------------------------------------------- the CLI


def _write_inputs(tmp_path, mode):
    df = _interactions(4)
    path = str(tmp_path / f"input.{mode}")
    if mode == "raw-csv":
        df.to_csv(path, header=False, index=False)
    elif mode == "yelp-csv":
        df[["user_id", "item_id", "timestamp"]].assign(stars=df["rating"]).to_csv(
            path, index=False)
    elif mode == "yelp-json":
        with open(path, "w") as f:
            for row in df.itertuples():
                date = f"2020-01-01 {row.timestamp // 3600:02d}:{row.timestamp // 60 % 60:02d}:" \
                       f"{row.timestamp % 60:02d}"
                f.write(json.dumps({"user_id": row.user_id, "business_id": row.item_id,
                                    "date": date, "stars": row.rating}) + "\n")
    else:
        r = np.random.default_rng(5)
        seqs = [[int(x) for x in r.integers(1, 50, size=r.integers(1, 20))] for _ in range(80)]
        if mode == "seq2pat-pth":
            path = str(tmp_path / "seq2pat_data.pth")
            torch.save(seqs, path)
        else:
            path = str(tmp_path / "seq2pat_data.npz")
            offsets = np.cumsum([0] + [len(s) for s in seqs]).astype(np.int64)
            np.savez(path, flat=np.concatenate([np.asarray(s, np.int32) for s in seqs]),
                     offsets=offsets)
        mode = "from-seq2pat"
    return mode, path


@pytest.mark.parametrize("mode", ["raw-csv", "yelp-csv", "yelp-json", "seq2pat-npz",
                                  "seq2pat-pth"])
def test_cli_writes_the_jax_scripts_files(tmp_path, monkeypatch, mode):
    flag, path = _write_inputs(tmp_path, mode)
    args = [f"--{flag}", path, "--max-seq-len", "8", "--domain-idx", "1"]
    cli.main(args + ["--out", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["preprocess.py", *args, "--out", str(tmp_path / "jax")])
    runpy.run_path(os.path.join(REPO, "scripts", "preprocess.py"), run_name="__main__")
    for name in FILES:
        with np.load(tmp_path / "port" / name) as got, np.load(tmp_path / "jax" / name) as want:
            assert sorted(got.files) == sorted(want.files), name
            for key in want.files:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name}:{key}")
    with np.load(tmp_path / "port" / "train.npz") as z:
        assert len(z["user_id"]) > 0


def test_cli_from_seq2pat_needs_no_pandas(tmp_path):
    """``--from-seq2pat`` on a machine without pandas (the CSV and JSON
    modes import it where they read)."""
    _, path = _write_inputs(tmp_path, "seq2pat-npz")
    probe = ("import sys; sys.modules['pandas'] = None\n"
             "from dr4sr_tpu_torch.scripts import preprocess\n"
             f"preprocess.main(['--from-seq2pat', {path!r}, '--out', {str(tmp_path / 'out')!r}])\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert os.path.exists(tmp_path / "out" / "seq2pat_data.npz")
