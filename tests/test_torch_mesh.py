"""The port's mesh on the CPU (4 ranks in one gloo group): the rank layout
against the JAX package's create_mesh / create_serving_mesh device order,
the fsdp sharding rule against the JAX package's shard_over_fsdp,
the frame <-> row exchange and its backward against the plain permutes, the
loader's per-rank shards against the JAX loader's, the collective stop flag,
and one ``python -m torch.distributed.run --nproc-per-node 2`` run of
``generate --cpu --data-parallel 2`` against the single-process command.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from synfmc_tpu.data.loader import ShardedLoader as JaxLoader
from jax.sharding import PartitionSpec
from synfmc_tpu.parallel.mesh import create_mesh, create_serving_mesh, shard_over_fsdp
from synfmc_tpu_torch.data.loader import ShardedLoader
from synfmc_tpu_torch.parallel.collectives import row_splits
from synfmc_tpu_torch.parallel.mesh import fsdp_rows
from synfmc_tpu_torch.scripts import generate
from tests._torch_mesh import RankPool
from tests.test_torch_slice import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(WORLD)
    yield pool
    pool.close()


@pytest.mark.parametrize("sizes", [{"data": 2, "fsdp": 1, "sp": 2}, {"data": 1, "fsdp": 2, "sp": 2},
                                   {"data": 4, "fsdp": 1, "sp": 1}, {"data": 2, "sp": 2}])
def test_rank_layout_matches_the_jax_device_order(ranks, sizes):
    """Rank r sits where device r sits in the JAX mesh, and each axis's line
    through it holds the ranks of the devices along that axis."""
    devices = jax.devices()[:WORLD]
    if "fsdp" in sizes:
        mesh = create_mesh(sizes["data"], sizes["fsdp"], sizes["sp"], devices=devices)
    else:
        mesh = create_serving_mesh(sizes["data"], sizes["sp"], devices=devices)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    assert mesh.axis_names == tuple(sizes)
    for r, got in enumerate(ranks.run("tests._torch_mesh:layout", sizes)):
        where = tuple(int(i) for i in np.argwhere(ids == devices[r].id)[0])
        for i, name in enumerate(mesh.axis_names):
            line = ids[tuple(slice(None) if j == i else where[j] for j in range(len(where)))]
            assert got[name] == (where[i], tuple(int(d) for d in line)), (r, name)


# named shapes: a conv weight, a Dense weight and a vector that split; a dim 0
# that 2 divides and 4 does not; tensors under 1024 elements; a scalar
RULE_SHAPES = {"conv": (320, 320, 3, 3), "dense": (1280, 320), "long_bias": (2048,),
               "odd_rows": (6, 640), "bias": (320,), "small": (16, 63), "one_row": (1, 4096),
               "scalar": ()}


@pytest.mark.parametrize("fsdp", [2, 4])
def test_fsdp_rows_follow_shard_over_fsdp(fsdp):
    """fsdp_rows, a pure function of the names and shapes, splits exactly the
    tensors that the JAX package's shard_over_fsdp puts on P('fsdp') (given
    the same shapes), and the ranks' rows of each tile its dim 0 in order."""
    mesh = create_mesh(1, fsdp, 1, devices=jax.devices()[:fsdp])
    placed = shard_over_fsdp({n: np.zeros(s, np.float32) for n, s in RULE_SHAPES.items()}, mesh)
    want = {n: x.sharding.spec == PartitionSpec("fsdp") for n, x in placed.items()}
    assert want["conv"] and want["dense"] and not want["bias"] and not want["small"]
    assert want["odd_rows"] == (fsdp == 2)
    ranks = [fsdp_rows(RULE_SHAPES, fsdp, i) for i in range(fsdp)]
    for n, shape in RULE_SHAPES.items():
        assert (ranks[0][n] is not None) == want[n], n
        if want[n]:
            rows = [np.arange(shape[0])[r[n]] for r in ranks]
            assert len({len(x) for x in rows}) == 1
            np.testing.assert_array_equal(np.concatenate(rows), np.arange(shape[0]))
        else:
            assert all(r[n] is None for r in ranks), n
    assert fsdp_rows(RULE_SHAPES, 1, 0) == dict.fromkeys(RULE_SHAPES)


@pytest.mark.parametrize("shape", [(1, 4, 3, 8, 6), (2, 8, 2, 5, 4)])
def test_exchange_and_its_backward_match_the_plain_permutes(ranks, shape):
    """frames_to_rows -> a product over frames -> rows_to_frames on sp = 4:
    24 rows split 8/8/8/0 (a rank with none), 20 rows 5 each; the rows, the
    frames and the gradients against the single-process permutes."""
    rng = np.random.default_rng(0)
    b, f, h, w, c = shape
    x = rng.normal(size=shape).astype(np.float32)
    weight = rng.normal(size=(f, f)).astype(np.float32)
    outs = ranks.run("tests._torch_mesh:exchange", x, weight)
    splits = row_splits(b * h * w, WORLD)
    assert splits == ([8, 8, 8, 0] if b * h * w == 24 else [5, 5, 5, 5])
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(weight).requires_grad_(True)
    rows = xt.permute(0, 2, 3, 1, 4).reshape(b * h * w, f, c)
    back = torch.einsum("nfc,fg->ngc", rows, wt).reshape(b, h, w, f, c).permute(0, 3, 1, 2, 4)
    fl = f // WORLD
    weights = torch.zeros(back.shape)
    for r in range(WORLD):  # each rank's loss weights its own frames
        weights[:, r * fl:(r + 1) * fl] = torch.arange(b * fl * h * w * c).reshape(
            b, fl, h, w, c).float()
    (back * weights).sum().backward()
    lo = 0
    for r, o in enumerate(outs):
        assert o["splits"] == splits
        np.testing.assert_allclose(o["rows"], rows.detach()[lo:lo + splits[r]].numpy(), rtol=0,
                                   atol=0)
        frames = slice(r * fl, (r + 1) * fl)
        np.testing.assert_allclose(o["back"], back.detach()[:, frames].numpy(), rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_allclose(o["dx"], xt.grad[:, frames].numpy(), rtol=1e-6, atol=1e-3)
        lo += splits[r]
    dw = sum(o["dw"] for o in outs)
    np.testing.assert_allclose(dw, wt.grad.numpy(), rtol=1e-5, atol=1e-2)


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n,count", [(12, 2), (12, 3), (10, 3), (11, 2)])
def test_loader_shards_match_the_jax_loader(n, count):
    """The global permutation of the global seed, stride-sliced per rank as
    the JAX loader slices it, each shard cut to n // count so that every rank
    has the same number of batches (where count does not divide n the JAX
    loader's first shards hold one sample more)."""
    ds = _Sized(n)
    shards = []
    for i in range(count):
        for epoch in (0, 3):
            want = JaxLoader(ds, 2, list, seed=5, num_workers=0, process_index=i,
                             process_count=count, drop_last=False)._epoch_indices(epoch)
            got = ShardedLoader(ds, 2, list, seed=5, num_workers=0, process_index=i,
                                process_count=count, drop_last=False)._epoch_indices(epoch)
            np.testing.assert_array_equal(got, want[:n // count])
            if epoch == 0:
                shards.append(got)
    assert len({len(ShardedLoader(ds, 2, list, num_workers=0, process_index=i,
                                  process_count=count)) for i in range(count)}) == 1
    flat = np.concatenate(shards)
    assert len(set(flat.tolist())) == len(flat) == count * (n // count)


def test_stop_flag_is_the_or_over_ranks(ranks):
    flags = [[False] * WORLD, [False, False, True, False], [True] * WORLD]
    assert ranks.run("tests._torch_mesh:stop_flag", flags) == [[False, True, True]] * WORLD


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_generate_data_parallel_under_torchrun(tmp_path, capsys):
    """Two prompts over 2 ranks: rank 0 alone writes the GIF and the frames,
    which match the single-process command's; without the launcher the flag
    raises and names it."""
    cfg = tiny_config()
    cfg["train_data"]["params"]["sample_size"] = [64, 64]
    config = tmp_path / "tiny.yaml"
    config.write_text(yaml.safe_dump(cfg))
    args = ["--config", str(config), "--prompt", "a knight marches", "--prompt",
            "a dragon soars", "--cpu", "--num-inference-steps", "2", "--video-length", "4",
            "--seed", "3"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-port", str(_free_port()), "-m", "synfmc_tpu_torch.scripts.generate",
           *args, "--data-parallel", "2", "--out", str(tmp_path / "dp.gif"),
           "--save-frames", str(tmp_path / "dp.npz")]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert proc.stdout.count("# generate: rank ") == 2 and proc.stdout.count("wrote ") == 1
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert generate.main([*args, "--out", str(tmp_path / "one.gif"),
                              "--save-frames", str(tmp_path / "one.npz")]) == 0
    finally:
        torch.set_num_threads(threads)
    dp, one = np.load(tmp_path / "dp.npz"), np.load(tmp_path / "one.npz")
    assert dp["video"].shape == one["video"].shape == (2, 4, 64, 64, 3)
    np.testing.assert_array_equal(dp["input_ids"], one["input_ids"])
    np.testing.assert_allclose(dp["video"], one["video"], atol=1e-5, rtol=0)
    capsys.readouterr()
    with pytest.raises(SystemExit):
        generate.parse_args([*args, "--data-parallel", "2"])
    assert "python -m torch.distributed.run --nproc-per-node" in capsys.readouterr().err
