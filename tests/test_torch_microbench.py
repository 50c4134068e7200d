"""The plain versions of the microbenchmarks P1-P3 (utils/microbench.py)
against numpy loops written out row by row, at tiny sizes. All their
outputs are integers or float32 chains computed op for op, so they must
match exactly. Their kernels run only on the card (chip_smoke.py holds
them to these plain versions there); here the wrappers refuse CPU
tensors."""
import numpy as np
import pytest
import torch

from cudatracerlib_tpu_torch.utils import microbench as mb

ROWS = 37


def _table(seed=0):
    r = np.random.default_rng(seed)
    bits = r.integers(-2 ** 31, 2 ** 31 - 1, (ROWS, 128), dtype=np.int64).astype(np.int32)
    return bits, torch.from_numpy(bits.view(np.float32).copy())


def _xor(row_bits):
    h = 0
    for w in row_bits:
        h ^= int(w) & 0xFFFFFFFF
    return h


def test_chase_rows_matches_numpy_loop():
    bits, table = _table(1)
    idx0 = np.random.default_rng(2).integers(0, ROWS, 23).astype(np.int32)
    got = mb.chase_rows(table, torch.from_numpy(idx0), 9).numpy()
    for c, start in enumerate(idx0):
        idx = int(start)
        for s in range(9):
            idx = ((_xor(bits[idx]) + s * 0x9E3779B9) % 2 ** 32) % ROWS
        assert got[c] == idx
    assert got.dtype == np.int32


def test_chase_rows_node_step_matches_numpy_loop():
    """With words=14 a step's row value is the xor of its first 56 words
    (what a traversal's node step reads)."""
    bits, table = _table(5)
    idx0 = np.random.default_rng(6).integers(0, ROWS, 19).astype(np.int32)
    got = mb.chase_rows(table, torch.from_numpy(idx0), 7, words=mb.NODE_WORDS).numpy()
    for c, start in enumerate(idx0):
        idx = int(start)
        for s in range(7):
            idx = ((_xor(bits[idx][:4 * mb.NODE_WORDS]) + s * 0x9E3779B9) % 2 ** 32) % ROWS
        assert got[c] == idx


def test_gather_rows_matches_numpy_loop():
    bits, table = _table(3)
    idx = np.random.default_rng(4).integers(0, ROWS, 101).astype(np.int32)
    got = mb.gather_rows(table, torch.from_numpy(idx)).numpy()
    want = np.array([_xor(bits[i]) for i in idx], np.uint32).view(np.int32)
    np.testing.assert_array_equal(got, want)


def test_loop_only_matches_numpy_loop():
    x0 = np.random.default_rng(5).random(16, dtype=np.float32)
    x = x0.copy()
    for _ in range(300):
        x = (x * np.float32(mb.LOOP_FACTOR)).astype(np.float32) + np.float32(1.0)
    np.testing.assert_array_equal(mb.loop_only(torch.from_numpy(x0), 300).numpy(), x)


@pytest.mark.parametrize("n,warps", [(1, 1), (31, 1), (1000, 4), (4097, 3)])
def test_queue_fetch_hands_out_every_item_once(n, warps):
    counts = mb.queue_fetch(n, warps)
    assert counts.dtype == torch.int32 and counts.shape == (n,)
    # the warp queue as a numpy loop: warps in turn claim 32 items each
    want, counter = np.zeros(n, np.int32), 0
    while counter < n:
        for _ in range(warps):
            for lane in range(32):
                if counter + lane < n:
                    want[counter + lane] += 1
            counter += 32
    np.testing.assert_array_equal(counts.numpy(), want)
    assert (want == 1).all()


def test_bound_is_the_larger_of_bytes_and_operations():
    ms, by = mb.bound_ms(3.35e9, 1.0)
    assert by == "bytes" and abs(ms - 1.0) < 1e-12
    ms, by = mb.bound_ms(1.0, 67e9)
    assert by == "operations" and abs(ms - 1.0) < 1e-12


def test_wrappers_refuse_cpu_tensors():
    _, table = _table()
    idx = torch.zeros(4, dtype=torch.int32)
    before = [k.launches for k in mb.KERNELS]
    with pytest.raises(ValueError):
        mb.chase_rows_cuda(table, idx, 3)
    with pytest.raises(ValueError):
        mb.gather_rows_cuda(table, idx)
    with pytest.raises(ValueError):
        mb.loop_only_cuda(torch.ones(4), 3)
    with pytest.raises(ValueError):
        mb.queue_fetch_cuda(8, "cpu")
    assert [k.launches for k in mb.KERNELS] == before
