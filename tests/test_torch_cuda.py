"""The port on the card, and the package rules.  Nothing here imports JAX,
so the file also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tests marked ``gpu`` skip without a CUDA card; they hold the hand-written
lookup kernel bit-identical to its plain PyTorch version and drive a
small frame through it."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import IndexedFrame, Schema
from repro_torch.core import append, create_index
from repro_torch.kernels import hash_probe, ref

SRC = Path(__file__).resolve().parents[1] / "src"
SCH = Schema.of("k", k="int64", v="float32", tag="int32")
I64 = np.iinfo(np.int64)


def _cols(rng, n, key_range, tag0=0):
    return {"k": rng.integers(0, key_range, n).astype(np.int64),
            "v": rng.random(n).astype(np.float32),
            "tag": np.arange(tag0, tag0 + n, dtype=np.int32)}


def test_import_pulls_in_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.frame, repro_torch.convert;"
            "import repro_torch.kernels.ops;"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'));"
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_default_device_is_the_card():
    """``device=None`` lands on CUDA; without a card it raises rather
    than running on the CPU."""
    c = _cols(np.random.default_rng(0), 50, 10)
    if torch.cuda.is_available():
        f = IndexedFrame.from_columns(c, SCH, rows_per_batch=16)
        assert f.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            IndexedFrame.from_columns(c, SCH, rows_per_batch=16)
    f = IndexedFrame.from_columns(c, SCH, rows_per_batch=16, device="cpu")
    assert f.device.type == "cpu"


def test_unported_methods_name_their_roadmap_item():
    f = IndexedFrame.from_columns(_cols(np.random.default_rng(0), 20, 5),
                                  SCH, rows_per_batch=16, device="cpu")
    for call, item in [(lambda: f.flush(), "A8"),
                       (lambda: f.save("x"), "A6"),
                       (lambda: f.reshard(2), "A12"),
                       (lambda: f.pending_rows, "A8"),
                       (lambda: f.append({}, queued=True), "A8")]:
        with pytest.raises(NotImplementedError, match=item):
            call()
    with pytest.raises(NotImplementedError, match="A12"):
        IndexedFrame.from_columns({}, SCH, num_shards=2, device="cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        IndexedFrame.from_columns({}, SCH, track_hot=8, device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        IndexedFrame.from_columns({}, SCH, partition_by=object(),
                                  device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _table(seed, n_segments, device, key_range=60):
    rng = np.random.default_rng(seed)
    t = create_index(_cols(rng, 300, key_range), SCH, rows_per_batch=16,
                     reserve=0, device=device)
    for i in range(n_segments - 1):
        n = int(rng.choice([5, 40, 130]))
        t = append(t, _cols(rng, n, key_range, 1000 * (i + 1)),
                   mode="segment")
    return t


def _queries(seed, key_range=60):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, key_range, 333),
                           rng.integers(key_range, 3 * key_range, 9),
                           [I64.min, I64.max, -1]]).astype(np.int64)


@pytest.mark.gpu
@pytest.mark.parametrize("n_segments", [1, 2, 8, 20])
def test_kernel_matches_plain_version(cuda, n_segments):
    snap = _table(n_segments, n_segments, cuda).snapshot
    q = torch.from_numpy(_queries(n_segments)).to(cuda)
    before = hash_probe.LAUNCHES
    for m in (1, 8, 64):
        rows, last = hash_probe.fused_lookup_tiles(q, snap, max_matches=m)
        want_rows, want_last = ref.fused_lookup_ref(q, snap, m)
        torch.cuda.synchronize()
        assert torch.equal(rows, want_rows) and torch.equal(last, want_last)
    assert hash_probe.LAUNCHES == before + 3


@pytest.mark.gpu
def test_kernel_masks_garbage_past_fill(cuda):
    snap = _table(5, 3, cuda).snapshot
    cap = snap.capacity
    fill = cap - 60
    g = torch.Generator(device=cuda).manual_seed(0)
    prev = snap.prev.clone()
    prev[fill:] = torch.randint(-3, cap, (cap - fill,), generator=g,
                                device=cuda, dtype=torch.int32)
    forged = torch.randperm(fill, generator=g, device=cuda)[:25]
    prev[forged] = torch.randint(fill, cap, (25,), generator=g, device=cuda,
                                 dtype=torch.int32)
    snap = dataclasses.replace(snap, prev=prev,
                               fill=torch.tensor(fill, dtype=torch.int32,
                                                 device=cuda))
    q = torch.from_numpy(_queries(5)).to(cuda)
    rows, last = hash_probe.fused_lookup_tiles(q, snap, max_matches=16)
    want_rows, want_last = ref.fused_lookup_ref(q, snap, 16)
    assert torch.equal(rows, want_rows) and torch.equal(last, want_last)
    assert int(rows.max()) < fill


@pytest.mark.gpu
def test_frame_on_card_matches_cpu_frame(cuda):
    """The same build -> lookup -> append -> join on the card and on the
    CPU gives the same answers, and the card's path went through the
    kernel on both the read and the ingest side."""
    rng = np.random.default_rng(9)
    base, delta = _cols(rng, 400, 50), _cols(rng, 37, 50, 10_000)
    probe = {"k": rng.integers(-5, 55, 200).astype(np.int64)}
    out = {}
    for dev in ("cpu", cuda):
        f = IndexedFrame.from_columns(base, SCH, rows_per_batch=16,
                                      device=dev)
        n0 = hash_probe.LAUNCHES
        f2 = f.append(delta)
        n1 = hash_probe.LAUNCHES
        cols, valid = f2.lookup(np.arange(50, dtype=np.int64),
                                max_matches=20)
        bcols, _, bvalid = f2.join(probe, "k", max_matches=8)
        n2 = hash_probe.LAUNCHES
        out[str(dev)] = (cols["tag"].cpu(), valid.cpu(),
                         bcols["tag"].cpu(), bvalid.cpu())
        if dev != "cpu":
            assert n1 > n0 and n2 >= n1 + 2
        else:
            assert n2 == n0
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert torch.equal(a, b)
