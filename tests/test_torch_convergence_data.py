"""The port's convergence-corpus generator
(``tdanet_tpu_torch/scripts/make_convergence_data.py``) against the JAX
package's ``scripts/make_convergence_data.py``: at n_train 4 every wav of
the three splits equal byte for byte and every manifest equal once its
paths are made relative to the corpus root, in the default regime and in
two WHAM-style ones (noise, four sources, variable lengths)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tdanet_tpu_torch.scripts import make_convergence_data as tgen
from tdanet_tpu_torch.utils.audio_io import read_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {
    "default": [],
    "n_src4_noise10_varlen": ["--n_src", "4", "--noise_snr", "10",
                              "--var_len", "2.5,4.0"],
    "noise8_varlen": ["--noise_snr", "8", "--var_len", "2.5,4.0"],
}


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _relative_manifest(data, root):
    return [[os.path.relpath(p, root), n] for p, n in json.loads(data)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_generator_equals_the_jax_script(case, tmp_path):
    extra = CASES[case]
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable,
                    os.path.join(REPO, "scripts", "make_convergence_data.py"),
                    jroot, "4", *extra], check=True, env=env, cwd=REPO,
                   capture_output=True, timeout=300)
    tgen.main([troot, "4", *extra])
    want, got = _tree(jroot), _tree(troot)
    assert sorted(got) == sorted(want)
    n_src = int(extra[extra.index("--n_src") + 1]) if "--n_src" in extra \
        else 2
    mix = "mix_both" if "--noise_snr" in extra else "mix_clean"
    channels = [mix] + [f"s{i + 1}" for i in range(n_src)]
    sizes = {"tr": 4, "dev": 100, "tt": 100}
    assert len(got) == sum(sizes.values()) * len(channels) \
        + len(sizes) * len(channels)
    for rel, data in want.items():
        if rel.endswith(".json"):
            assert _relative_manifest(got[rel], troot) \
                == _relative_manifest(data, jroot), rel
        else:
            assert got[rel] == data, rel
    # the manifests' lengths are the wavs' frames; variable lengths vary
    lengths = set()
    for split, n in sizes.items():
        with open(os.path.join(troot, split, f"{mix}.json")) as f:
            rows = json.load(f)
        assert len(rows) == n
        for p, frames in rows[:3]:
            wav, sr = read_wav(p)
            assert sr == tgen.SR and wav.shape == (frames,)
            assert wav.dtype == np.float32 and np.isfinite(wav).all()
        lengths |= {frames for _, frames in rows}
    assert lengths == {24000} if "--var_len" not in extra \
        else len(lengths) > 100


def test_utterance_draw_order():
    """A length is drawn first even at a fixed 3 s, then the voices, then
    the noise: the sources of an utterance do not depend on the noise,
    and the fixed-length draw still moves the voices' stream."""
    clean_mix, clean = tgen.utterance(7)
    noisy_mix, noisy = tgen.utterance(7, noise_snr=5.0)
    for a, b in zip(clean, noisy):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(clean_mix, noisy_mix)
    rng = np.random.default_rng(7)
    rng.uniform(3.0, 3.0)
    np.testing.assert_array_equal(clean[0],
                                  tgen.voice(rng, *tgen.BANDS[0], 24000))
    with pytest.raises(ValueError, match="bands"):
        tgen.make_corpus("/nonexistent", 1, n_src=5)
