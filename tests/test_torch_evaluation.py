"""The port's evaluation tools (synfmc_tpu_torch/evaluation, scripts/evaluate.py)
against the JAX package's on the same seeded inputs: the metrics in float64
within 1e-12, the Fréchet distance of tests/test_fid.py's cases within 1e-9
relative, the FID seam through one TorchScript extractor within 1e-6
relative, and the evaluate command line's JSON."""

import importlib.util
import json
import os
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from synfmc_tpu.evaluation import fid as jax_fid
from synfmc_tpu.evaluation import metrics as jax_metrics
from synfmc_tpu.geometry import euler_to_matrix_v2
from synfmc_tpu_torch.evaluation import fid, metrics
from synfmc_tpu_torch.scripts import evaluate as port_cli
from synfmc_tpu_torch.utils.video import encode_gif, save_camera_label_txt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_cli():
    """scripts/evaluate.py, the JAX package's command line, as a module."""
    spec = importlib.util.spec_from_file_location("jax_evaluate_cli",
                                                  os.path.join(REPO, "scripts", "evaluate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rotations(rng, n):
    return np.stack([euler_to_matrix_v2(*rng.uniform(-40, 40, size=3)) for _ in range(n)])


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.uniform(size=(2, 4, 16, 24, 3))
    assert metrics.psnr(a, b) == pytest.approx(jax_metrics.psnr(a, b), abs=1e-12)
    assert metrics.psnr(a, a) == jax_metrics.psnr(a, a) == float("inf")
    r1, r2 = _rotations(rng, 8), _rotations(rng, 8)
    np.testing.assert_allclose(metrics.rot_err_deg(r1, r2), jax_metrics.rot_err_deg(r1, r2),
                               rtol=0, atol=1e-12)
    t1, t2 = rng.normal(size=(2, 8, 3))
    for normalize in (True, False):
        np.testing.assert_allclose(metrics.trans_err(t1, t2, normalize),
                                   jax_metrics.trans_err(t1, t2, normalize), rtol=0, atol=1e-12)


def _write_labels(d, rng, n=3, frames=6):
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        for kind in ("compute", "gt"):
            rt = np.concatenate([_rotations(rng, frames), rng.normal(size=(frames, 3, 1))], -1)
            save_camera_label_txt(os.path.join(d, f"cam_label_{kind}_{i}.txt"), "a prompt", rt)


def test_camera_label_files_match_jax(tmp_path):
    _write_labels(str(tmp_path), np.random.default_rng(1))
    for i in range(3):
        pred, gt = (str(tmp_path / f"cam_label_{k}_{i}.txt") for k in ("compute", "gt"))
        got = metrics.camera_errors_from_label_txt(pred, gt)
        want = jax_metrics.camera_errors_from_label_txt(pred, gt)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)
    rts = np.asarray(metrics.parse_camera_label_txt(pred))
    np.testing.assert_array_equal(rts, jax_metrics.parse_camera_label_txt(pred))


def _fid_cases():
    """tests/test_fid.py's inputs, and a rank-deficient pair that takes the
    diagonal-loading branch."""
    rng = np.random.default_rng(0)
    f = rng.normal(size=(500, 16))
    mu, sigma = jax_fid.compute_statistics(f)
    yield (mu, sigma, mu, sigma)
    yield (np.zeros(8), np.eye(8), np.full(8, 0.5), np.eye(8))
    yield (np.zeros(3), np.diag([1.0, 4.0, 9.0]), np.zeros(3), np.diag([4.0, 1.0, 16.0]))
    rng = np.random.default_rng(1)
    fa, fb = rng.normal(size=(4000, 4)), rng.normal(size=(4000, 4)) + [1.0, 0.0, -1.0, 0.5]
    yield (*jax_fid.compute_statistics(fa), *jax_fid.compute_statistics(fb))
    rng = np.random.default_rng(2)
    A = rng.normal(size=(6, 6))
    cov = A @ A.T + 0.1 * np.eye(6)
    fa = rng.multivariate_normal(np.zeros(6), cov, size=3000)
    fb = rng.multivariate_normal(np.zeros(6), cov, size=3000)
    yield (*jax_fid.compute_statistics(fa), *jax_fid.compute_statistics(fb))
    rng = np.random.default_rng(3)
    yield (*jax_fid.compute_statistics(rng.normal(size=(5, 12))),
           *jax_fid.compute_statistics(rng.normal(size=(5, 12)) * 2))


@pytest.mark.parametrize("case", range(6))
def test_frechet_distance_matches_jax(case):
    args = list(_fid_cases())[case]
    want = jax_fid.frechet_distance(*args)
    got = fid.frechet_distance(*args)
    assert got == pytest.approx(want, rel=1e-9, abs=1e-12)


def test_statistics_and_extract_match_jax():
    rng = np.random.default_rng(4)
    f = rng.normal(size=(40, 5))
    for got, want in zip(fid.compute_statistics(f), jax_fid.compute_statistics(f)):
        np.testing.assert_array_equal(got, want)
    batches = [rng.normal(size=(3, 4, 5)) for _ in range(2)]
    ext = lambda b: b.reshape(len(b), -1) * 2.0
    np.testing.assert_array_equal(fid.extract_features(batches, ext),
                                  jax_fid.extract_features(batches, ext))
    assert fid.fvd_from_features(f, f * 1.5) == jax_fid.fvd_from_features(f, f * 1.5)


def _extractor(path, video=False):
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = (torch.nn.Conv3d if video else torch.nn.Conv2d)(3, 8, 3, padding=1)

        def forward(self, x):
            return torch.relu(self.conv(x)).flatten(2).mean(dim=2)

    torch.manual_seed(0)
    torch.jit.script(Net()).save(path)
    return path


def _gif_dir(d, seed, n=3):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        frames = (rng.uniform(size=(4, 16, 24, 3)) * 255).astype(np.uint8)
        imageio.mimwrite(os.path.join(d, f"{i}.gif"), list(frames))


@pytest.mark.parametrize("video", [False, True])
def test_frechet_extracted_matches_jax(tmp_path, video):
    ext = _extractor(str(tmp_path / "ext.pt"), video)
    _gif_dir(str(tmp_path / "a"), 0)
    _gif_dir(str(tmp_path / "b"), 1)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    want = _jax_cli().eval_frechet_extracted(a, b, ext, video_level=video)
    got = port_cli.eval_frechet_extracted(a, b, ext, video_level=video, device="cpu")
    assert {k: v for k, v in got.items() if k != "frechet_distance"} == \
        {k: v for k, v in want.items() if k != "frechet_distance"}
    assert got["frechet_distance"] == pytest.approx(want["frechet_distance"], rel=1e-6)


def _run_both(monkeypatch, capsys, argv):
    jax = _jax_cli()
    monkeypatch.setattr(sys, "argv", ["evaluate.py", *argv])
    jax.main()
    want = capsys.readouterr().out
    assert port_cli.main([*argv, "--cpu"]) == 0
    got = capsys.readouterr().out
    return json.loads(got), json.loads(want)


def test_cli_json_matches_jax(tmp_path, monkeypatch, capsys):
    _write_labels(str(tmp_path / "samples"), np.random.default_rng(5))
    rng = np.random.default_rng(6)
    a = (rng.uniform(size=(3, 16, 24, 3)) * 255).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-5, 6, size=a.shape), 0, 255).astype(np.uint8)
    pa, pb, pc = (str(tmp_path / n) for n in ("a.gif", "b.gif", "c.gif"))
    imageio.mimwrite(pa, list(a))
    imageio.mimwrite(pb, list(b))
    with open(pc, "wb") as fh:
        fh.write(encode_gif(b))
    for argv in (["--samples-dir", str(tmp_path / "samples")],
                 ["--pred", str(tmp_path / "samples" / "cam_label_compute_1.txt"),
                  "--gt", str(tmp_path / "samples" / "cam_label_gt_1.txt")],
                 ["--video-a", pa, "--video-b", pb], ["--video-a", pa, "--video-b", pa],
                 ["--video-a", pc, "--video-b", pb]):
        got, want = _run_both(monkeypatch, capsys, argv)
        assert got == want, argv
    assert got["video"]["frames_compared"] == 3


def test_cli_features_and_mp4(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(7)
    np.save(tmp_path / "fa.npy", rng.normal(size=(30, 6)))
    np.savez(tmp_path / "fb.npz", features=rng.normal(size=(20, 6)) + 0.3)
    got, want = _run_both(monkeypatch, capsys, ["--features-a", str(tmp_path / "fa.npy"),
                                                 "--features-b", str(tmp_path / "fb.npz")])
    assert got["frechet"]["frechet_distance"] == pytest.approx(
        want["frechet"]["frechet_distance"], rel=1e-12)
    with pytest.raises(ValueError, match="MP4"):
        port_cli.load_frames(str(tmp_path / "clip.mp4"))
