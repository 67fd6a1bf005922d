"""The port's eval metrics against the JAX package's: BSS-eval SDR and its
PIT (n_src 2, 3, 4), both trackers' rows, CSV and footer in float64, and
the progress display without rich."""
import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tdanet_tpu.losses import sdr as jsdr  # noqa: E402
from tdanet_tpu_torch import metrics as tmetrics  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Jnp64:
    """jax.numpy with float32 read as float64 (the JAX losses cast to
    float32; here they run in float64 beside the port)."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _sources(n_src, T, seed):
    """Sources, a mixture and an estimate that is a mix of delayed,
    scaled sources plus noise, all float64."""
    rng = np.random.default_rng(seed)
    clean = rng.standard_normal((n_src, T))
    mix = clean.sum(0)
    perm = rng.permutation(n_src)
    est = 0.8 * np.roll(clean[perm], 3, axis=-1) + 0.2 * mix \
        + 0.1 * rng.standard_normal((n_src, T))
    return mix, clean, est


@pytest.mark.parametrize("n_src", [2, 3, 4])
def test_sdr_matrix_and_pit_match_jax(n_src):
    from tdanet_tpu.metrics import bss_eval as jbss
    _, clean, est = _sources(n_src, 3001, n_src)
    want = jbss.sdr_matrix(clean, est)
    got = tmetrics.sdr_matrix(clean, est)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    w_mean, w_per, w_perm = jbss.sdr_pit(clean, est)
    g_mean, g_per, g_perm = tmetrics.sdr_pit(clean, est)
    assert g_perm == w_perm and len(set(g_perm)) == n_src
    assert abs(g_mean - w_mean) <= 1e-10 * abs(w_mean)
    np.testing.assert_allclose(g_per, w_per, rtol=1e-10)


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("kind,n_src", [("MetricsTracker", 2),
                                        ("SPlitMetricsTracker", 3)])
def test_tracker_rows_csv_and_footer_match_jax_fp64(tmp_path, monkeypatch,
                                                     kind, n_src):
    """Three utterances through both trackers, JAX under x64 with its
    losses in float64, the port on float64 arrays: every returned row, the
    running update, the final dict and every CSV cell within 1e-9 dB."""
    from tdanet_tpu import metrics as jmetrics
    monkeypatch.setattr(jsdr, "jnp", _Jnp64())
    utts = [(_sources(n_src, 2000 + 37 * i, 10 + i), f"utt{i}.wav")
            for i in range(3)]
    out = {}
    with jax.enable_x64():
        for name, mod in (("jax", jmetrics), ("port", tmetrics)):
            path = str(tmp_path / f"{name}.csv")
            tracker = getattr(mod, kind)(path)
            rows = [tracker(mix, clean, est, key)
                    for (mix, clean, est), key in utts]
            out[name] = (rows, tracker.update(), tracker.final(),
                         _rows(path))
    (jr, ju, jf, jcsv), (pr, pu, pf, pcsv) = out["jax"], out["port"]
    assert list(pcsv[0]) == getattr(tmetrics, kind).COLUMNS
    assert [r["snt_id"] for r in pcsv] == ["utt0.wav", "utt1.wav",
                                           "utt2.wav", "avg", "std"]
    assert [r["snt_id"] for r in jcsv] == [r["snt_id"] for r in pcsv]
    for g, w in zip(pr, jr):
        assert g.keys() == w.keys() and g["snt_id"] == w["snt_id"]
        for k in list(g)[1:]:
            assert abs(g[k] - w[k]) <= 1e-9, (k, g[k], w[k])
    for g, w in ((pu, ju), (pf, jf)):
        assert g.keys() == w.keys()
        assert all(abs(g[k] - w[k]) <= 1e-9 for k in g)
    for g, w in zip(pcsv, jcsv):
        for k in list(g)[1:]:
            assert abs(float(g[k]) - float(w[k])) <= 1e-9, (k, g, w)
    assert all(np.isfinite(float(v)) for r in pcsv for v in list(
        r.values())[1:])


def test_sdr_quirk_puts_clean_in_the_estimate_slot():
    """The tracker's sdr is sdr_pit(estimate, clean) (clean projected on
    the estimate), its baseline sdr_pit(clean, mix): the two directions
    differ for a delayed estimate."""
    mix, clean, est = _sources(2, 2500, 3)
    row = tmetrics.MetricsTracker()(mix, clean, est, "x")
    want = tmetrics.sdr_pit(est, clean)[0]
    assert row["sdr"] == want != tmetrics.sdr_pit(clean, est)[0]
    assert row["sdr_i"] == want - tmetrics.sdr_pit(
        clean, np.stack([mix, mix]))[0]


@pytest.mark.parametrize("kind,n_src", [("MetricsTracker", 2),
                                        ("SPlitMetricsTracker", 3)])
def test_tracker_takes_mixed_dtypes_in_their_common_one(kind, n_src):
    """A float64 estimate beside float32 references (a float64 model on a
    float32 corpus) is scored in float64, as the JAX trackers promote."""
    mix, clean, est = _sources(n_src, 1500, 4)
    mixed = getattr(tmetrics, kind)()(mix.astype(np.float32),
                                      clean.astype(np.float32), est, "x")
    same = getattr(tmetrics, kind)()(mix.astype(np.float32).astype(
        np.float64), clean.astype(np.float32).astype(np.float64), est, "x")
    assert mixed == same


def test_eval_progress_without_rich():
    """The card's machine has no rich: with rich hidden, eval_progress
    gives a pass-through tracker and a column that prints the metrics."""
    code = (
        "import sys\n"
        "sys.modules['rich'] = None\n"
        "sys.modules['rich.progress'] = None\n"
        "sys.modules['rich.text'] = None\n"
        "from tdanet_tpu_torch.utils import progress\n"
        "assert not progress._HAVE_RICH\n"
        "bar, col = progress.eval_progress('Testing')\n"
        "with bar:\n"
        "    seen = list(bar.track(iter(range(3)), total=3))\n"
        "    bar.advance(bar.add_task('x'))\n"
        "assert seen == [0, 1, 2], seen\n"
        "col.update({'si-snr_i': 1.5})\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "{'si-snr_i': 1.5}"


def test_eval_progress_with_rich_renders_its_columns():
    pytest.importorskip("rich")
    from tdanet_tpu_torch.utils import progress
    bar, col = progress.eval_progress("Testing")
    col.update({"si-snr_i": 1.25, "n": 3})
    with bar:
        tid = bar.add_task("t", total=4)
        bar.advance(tid, 2)
        task = bar.tasks[0]
        assert str(col.render(task)) == "si-snr_i: 1.250 n: 3"
        assert str(progress.BatchesProcessedColumn().render(task)) == "2/4"
