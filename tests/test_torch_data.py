"""The port's data layer and config reader against the JAX package's: the
Python Loader over two epochs (shuffle, random crops, n_src 1 and 2,
normalize_audio), speed perturbation, the YAML reader against
yaml.safe_load on every config and on override values, save_yaml read
back by yaml.safe_load, and the argparse mirror."""
import glob
import math
import os

import numpy as np
import pytest
import torch

yaml = pytest.importorskip("yaml")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from tdanet_tpu.datas import datasets as jdata  # noqa: E402
from tdanet_tpu_torch.datas import datasets as tdata  # noqa: E402
from tdanet_tpu_torch.utils import parser as tparser  # noqa: E402
from test_data_metrics_utils import make_synth_split  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread a test, so that
    parallel test workers do not oversubscribe the cores (each op's
    parallel region would wait for threads the other workers hold)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.mark.parametrize("n_src,normalize", [(2, False), (1, True),
                                             (2, True)])
def test_loader_yields_the_jax_loaders_batches(tmp_path, n_src, normalize):
    """Same arrays (bit for bit) and names as tdanet_tpu's Python Loader
    over two epochs, shuffled, with random crops; one utterance shorter
    than the segment is dropped by both."""
    make_synth_split(str(tmp_path), n_utt=7, seconds=(0.4, 1.2), seed=3)
    kw = dict(n_src=n_src, sample_rate=8000, segment=0.5,
              normalize_audio=normalize)
    jds = jdata.SeparationDataset(str(tmp_path), **kw)
    tds = tdata.SeparationDataset(str(tmp_path), **kw)
    assert len(tds) == len(jds) and tds.drop_utt == jds.drop_utt == 1
    jl = jdata.Loader(jds, 2, shuffle=True, num_workers=2, seed=5)
    tl = tdata.Loader(tds, 2, shuffle=True, num_workers=2, seed=5)
    assert len(tl) == len(jl) > 1
    for _ in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == len(want)
        for (tm, ts, tn), (jm, js, jn) in zip(got, want):
            assert tn == jn and tm.dtype == jm.dtype == np.float32
            np.testing.assert_array_equal(tm, jm)
            np.testing.assert_array_equal(ts, js)
    # test-time items: full length, no crop
    x, _ = tdata.pad_to_lattice(np.ones((2, 10)), 4)
    assert x.shape == (2, 12)


def test_speed_perturb_batch_matches_jax():
    from tdanet_tpu.system.training_loop import speed_perturb_batch as jsp
    from tdanet_tpu_torch.system.training_loop import speed_perturb_batch
    src = np.random.default_rng(0).standard_normal((3, 2, 4000)) \
        .astype(np.float32)
    for seed in range(3):
        tm, ts = speed_perturb_batch(src, np.random.default_rng(seed))
        jm, js = jsp(src, np.random.default_rng(seed))
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(ts, js)


def test_reader_equals_safe_load_on_every_config(tmp_path):
    paths = sorted(glob.glob(os.path.join(REPO, "configs", "*.yml")))
    assert len(paths) >= 7
    for path in paths:
        with open(path) as f:
            want = yaml.safe_load(f)
        got = tparser.load_yaml(path)
        assert got == want, path
        out = str(tmp_path / "conf.yml")
        tparser.save_yaml(out, got)
        with open(out) as f:
            assert yaml.safe_load(f) == got, path
        assert tparser.load_yaml(out) == got


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


SCALARS = ["1e-3", "1.0e-3", "1.5E+3", "yes", "No", "on", "OFF", "true",
           "null", "~", "", "017", "0x1F", "0b11", "1_000", "1:30", "-1:30.5",
           ".inf", "-.Inf", ".NaN", "3.", ".5", "+1", "-0", "0.", "09",
           "'a # b'", "'it''s'", '"x\\ty"', "a #b", "hello world", "a:b",
           "-a", "a,b", "x[1]", "DataPreProcess/Libri2Mix/dev", "bf16",
           "16-mixed", "0o7", "+.5"]


def test_override_values_resolve_as_safe_load():
    for raw in SCALARS:
        assert _same(tparser.parse_scalar(raw), yaml.safe_load(raw)), raw
    conf = tparser.apply_overrides({"a": {"b": 1}}, [
        "a.b=2.0e-3", "a.c.d=yes", "e=null"])
    assert conf == {"a": {"b": 2e-3, "c": {"d": True}}, "e": None}
    for bad in ("[1, 2]", "- a", "a: b", "{x: 1}", "&anchor", "!!str x",
                "|", "2001-12-14", "a\tb"):
        with pytest.raises(tparser.YAMLSubsetError):
            tparser.parse_scalar(bad)


@settings(max_examples=300, deadline=None)
@given(st.text(alphabet=st.sampled_from(list(
    "0123456789+-._:eExXbBoO aAnNtTfFyYlLsSiI'\"#~,[]{}&*!|>%@`\\/=<?"
    "\t")), max_size=12))
def test_override_scalars_resolve_as_safe_load_or_raise(raw):
    """Whatever the reader returns, yaml.safe_load returns too; what it
    does not read it refuses with YAMLSubsetError."""
    try:
        got = tparser.parse_scalar(raw)
    except tparser.YAMLSubsetError:
        return
    assert _same(got, yaml.safe_load(raw)), raw


@settings(max_examples=100, deadline=None)
@given(st.recursive(
    st.one_of(st.none(), st.booleans(), st.integers(-10 ** 6, 10 ** 6),
              st.floats(allow_nan=False, width=64),
              st.text(alphabet=st.characters(min_codepoint=32,
                                             max_codepoint=126),
                      max_size=10)),
    lambda children: st.dictionaries(
        st.from_regex(r"[a-z_][a-z0-9_]{0,6}", fullmatch=True), children,
        min_size=1, max_size=4), max_leaves=12).filter(
            lambda v: isinstance(v, dict)))
def test_save_yaml_reads_back_the_same_dict(config):
    text = tparser.dumps_yaml(config)
    assert yaml.safe_load(text) == config
    assert tparser.loads_yaml(text) == config


def test_argparse_mirror_matches_jax():
    from tdanet_tpu.utils import parser as jparser
    conf = tparser.load_yaml(os.path.join(REPO, "configs", "tdanet.yml"))
    args = ["--lr", "0.005", "--seed", "3", "--SpeedAug", "true"]
    want = jparser.parse_args_as_dict(
        jparser.prepare_parser_from_dict(conf), args=args)
    got = tparser.parse_args_as_dict(
        tparser.prepare_parser_from_dict(conf), args=args)
    assert got == want and got["optimizer"]["lr"] == 0.005
