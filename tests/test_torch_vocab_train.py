"""Port parity: the vocabulary trainer (loop/vocabulary.py).

``build_default_corpus`` at one scene of each family against the
reference's (the reference at its default size trains for ~20 minutes on
the CPU: never called here): ORB rows bit-equal, LBD equal row counts and
at least 99.98% of bits equal (the line front end's rule since the port's
second slice). ``default_vocabulary`` trains and saves an artifact that is
missing, shown with a tiny corpus monkeypatched in, and the trainer tool
writes one of a scene.
"""

import os

import numpy as np
import pytest
import torch

from plslam_tpu.loop import vocabulary as jV
from plslam_tpu_torch.loop import vocabulary as tV


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["orb", "lbd"])
def test_corpus_matches_reference(kind):
    ref = jV.build_default_corpus(kind, n_scenes=1)
    got = tV.build_default_corpus(kind, n_scenes=1, device="cpu")
    assert got.dtype == np.uint8 and got.shape == ref.shape, (got.shape,
                                                              ref.shape)
    if kind == "orb":
        np.testing.assert_array_equal(got, ref)
    else:
        assert (got == ref).mean() >= 0.9998


def test_corpus_scenes_follow_the_reference_rng():
    """The scene arguments of a 400-scene LBD corpus, drawn as the
    reference draws them (the same rng calls in the same order)."""
    rng = np.random.default_rng(1000)
    for s, kw in enumerate(tV.corpus_scenes("lbd", 400)):
        d = kw["degrade"]
        assert (d.texture, d.noise, d.vignette) == (
            rng.uniform(0.0, 0.15), rng.uniform(0.002, 0.02),
            rng.uniform(0.0, 0.3))
        assert (kw["n_points"], kw["n_lines"], kw["step"]) == (
            rng.integers(150, 380), rng.integers(70, 128),
            rng.uniform(0.1, 0.5))
        assert kw["seed"] == 1000 + s
        assert kw["kind"] == ("forward" if s % 2 == 0 else "arc")


def test_default_vocabulary_trains_a_missing_artifact(tmp_path, monkeypatch):
    tiny = np.random.default_rng(0).integers(0, 2, (300, 256)).astype(
        np.uint8)
    calls = []
    monkeypatch.setattr(tV, "_DATA", str(tmp_path))
    monkeypatch.setattr(tV, "build_default_corpus",
                        lambda kind, device=None: calls.append(kind) or tiny)
    monkeypatch.setattr(tV, "_VOCAB_CACHE", {})
    voc = tV.default_vocabulary("orb", k=3, levels=2, device="cpu")
    path = tmp_path / "vocab_default_orb_3_2_v2.npz"
    assert calls == ["orb"] and path.exists()
    want = tV.build_vocabulary(tiny, k=3, levels=2, seed=1, device="cpu")
    assert torch.equal(voc.flat, want.flat)
    assert torch.equal(voc.idf, want.idf)
    # loaded, not trained, the second time
    tV._VOCAB_CACHE.clear()
    tV.default_vocabulary("orb", k=3, levels=2, device="cpu")
    assert calls == ["orb"]


def test_trainer_tool_writes_an_artifact(tmp_path, capsys):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "train_vocabulary_torch", os.path.join(
            os.path.dirname(__file__), os.pardir, "tools",
            "train_vocabulary_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--device", "cpu", "--out", str(tmp_path), "--k", "4",
                      "--levels", "2", "--kind", "lbd", "--scenes", "1",
                      "--workers", "0"]) == 0
    out = capsys.readouterr().out
    assert "lbd: corpus" in out and "empty leaves" in out and "median" in out
    voc = tV.load_vocabulary(str(tmp_path / "vocab_default_lbd_4_2_v2.npz"),
                             device="cpu")
    assert voc.k == 4 and voc.levels == 2
