"""The port's dataset pre-flight (synfmc_tpu_torch/scripts/validate_dataset.py)
against scripts/validate_dataset.py on the fixture and each corruption of
tests/test_validate_dataset.py: the same errors, warnings, counts and exit
code.  The one difference allowed: after "undecodable PNG <path>:" each
script names its own PNG reader's exception."""

import json
import os
import re
import shutil
import sys

import pytest
import yaml

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import validate_dataset as jax_validate  # noqa: E402

from synfmc_tpu.data.fixture import build_synthetic_dataset  # noqa: E402
from synfmc_tpu_torch.scripts import validate_dataset as port_validate  # noqa: E402


@pytest.fixture()
def params(tmp_path):
    kw = build_synthetic_dataset(str(tmp_path), num_seqs=2, num_objects=2,
                                 num_frames=48, height=64, width=96)
    kw.update(sample_n_frames=8, sample_size=(48, 64), max_objects=2,
              ori_fps=16, time_duration=3)
    return kw


def _norm(lines):
    return [re.sub(r"(undecodable PNG \S+): .*", r"\1", m) for m in lines]


def _missing_frames_and_masks(p):
    clip = os.path.join(p["data_root"], "Rendered_Traj_Results", "dynamic", "0")
    os.remove(os.path.join(clip, "0_0005.png"))
    shutil.rmtree(os.path.join(p["mask_root"], "Rendered_Traj_Results", "dynamic", "1", "24"))


def _corrupt_png_and_annotation(p):
    clip = os.path.join(p["data_root"], "Rendered_Traj_Results", "dynamic", "0")
    with open(os.path.join(clip, "0_0000.png"), "wb") as f:
        f.write(b"not a png at all")
    ann = os.path.join(p["lable_root"], "Rendered_Traj_Results", "dynamic", "1.json")
    with open(ann) as f:
        data = json.load(f)
    data["camera"] = data["camera"][:3]
    with open(ann, "w") as f:
        json.dump(data, f)


def _unknown_asset(p):
    with open(p["asset_json_file_path"]) as f:
        assets = json.load(f)
    assets.pop("asset0")
    with open(p["asset_json_file_path"], "w") as f:
        json.dump(assets, f)


def _short_clips(p):
    p["sample_n_frames"] = 10_000


CORRUPTIONS = {"clean": lambda p: None, "missing": _missing_frames_and_masks,
               "corrupt": _corrupt_png_and_annotation, "asset": _unknown_asset,
               "short": _short_clips}


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("case", list(CORRUPTIONS))
def test_same_report_as_jax(params, case, deep):
    CORRUPTIONS[case](params)
    got = port_validate.validate(dict(params), deep=deep)
    want = jax_validate.validate(dict(params), deep=deep)
    assert _norm(got.errors) == _norm(want.errors)
    assert got.warnings == want.warnings
    assert (got.sequences, got.frames_checked) == (want.sequences, want.frames_checked)
    assert bool(got.errors) == (case != "clean")


@pytest.mark.parametrize("case", ["clean", "corrupt"])
def test_command_line_matches_jax(params, tmp_path, monkeypatch, capsys, case):
    CORRUPTIONS[case](params)
    config = tmp_path / "cfg.yaml"
    config.write_text(yaml.safe_dump({"train_data": {"params": {
        k: list(v) if isinstance(v, tuple) else v for k, v in params.items()}}}))
    monkeypatch.setattr(sys, "argv", ["validate_dataset.py", "--config", str(config)])
    want_rc = jax_validate.main()
    want = capsys.readouterr().out
    got_rc = port_validate.main(["--config", str(config)])
    got = capsys.readouterr().out
    assert got_rc == want_rc == (0 if case == "clean" else 1)
    assert _norm(got.splitlines()) == _norm(want.splitlines())
