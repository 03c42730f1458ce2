"""`utils/memory.py` `retry_if_oom`, on functions that raise
`torch.OutOfMemoryError` above a batch size: the halves' outputs joined
give the unsplit output exactly (the function works image by image), dict,
tuple and numpy outputs join, other errors propagate untouched, and at
batch 1 it raises without moving anything to another device (the JAX
function's last rung, a call on the CPU, is not ported); and the instance
eval's restoration of its masks to the original size halves them."""

import numpy as np
import pytest
import torch

from bm2f_tpu_torch.utils.memory import retry_if_oom


class Capped:
    """fn(x, y) per item, raising OutOfMemoryError above `cap` items; every
    call's (batch, devices) recorded."""

    def __init__(self, cap, out="tensor"):
        self.cap, self.out, self.calls = cap, out, []

    def __call__(self, x, y):
        self.calls.append((x.shape[0], {str(a.device) for a in (x, y)
                                        if isinstance(a, torch.Tensor)}))
        if x.shape[0] > self.cap:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        z = x * 2 + torch.as_tensor(y).sum(-1, keepdim=True)
        if self.out == "dict":
            return {"z": z, "pair": (z + 1, (z * 3).numpy())}
        if self.out == "tuple":
            return z, [z.sum(-1), z[:, :1]]
        return z


def _inputs(n):
    rng = np.random.RandomState(n)
    return torch.from_numpy(rng.randn(n, 4).astype(np.float32)), rng.randn(n, 3)


@pytest.mark.parametrize("n,cap,splits", [(8, 2, 3), (7, 3, 2), (5, 1, 4), (4, 4, 0)])
def test_split_gives_the_unsplit_output(n, cap, splits):
    x, y = _inputs(n)
    want = Capped(n)(x, y)
    fn = Capped(cap)
    retry_if_oom.splits = 0
    got = retry_if_oom(fn)(x, y)
    assert torch.equal(got, want)
    assert retry_if_oom.splits == splits
    assert max(b for b, _ in fn.calls if b <= cap) <= cap
    assert sum(b for b, _ in fn.calls if b <= cap) == n  # every item once


@pytest.mark.parametrize("out", ["dict", "tuple"])
def test_dict_and_tuple_outputs_join(out):
    x, y = _inputs(6)
    want = Capped(6, out)(x, y)
    got = retry_if_oom(Capped(2, out))(x, y)
    if out == "dict":
        assert torch.equal(got["z"], want["z"])
        assert torch.equal(got["pair"][0], want["pair"][0])
        assert isinstance(got["pair"], tuple)
        np.testing.assert_array_equal(got["pair"][1], want["pair"][1])
    else:
        assert isinstance(got, tuple) and isinstance(got[1], list)
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_other_errors_propagate():
    calls = []

    def fn(x):
        calls.append(x.shape[0])
        raise RuntimeError("CUDA error: an illegal memory access (not out of memory)")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        retry_if_oom(fn)(torch.zeros(4, 2))
    assert calls == [4]  # no retry, no split

    def shaped(x):
        raise ValueError("bad shape")

    with pytest.raises(ValueError, match="bad shape"):
        retry_if_oom(shaped)(torch.zeros(4, 2))


def test_batch_one_raises_and_stays_on_the_device():
    fn = Capped(0)
    x, y = _inputs(2)
    with pytest.raises(torch.OutOfMemoryError, match=r"batch 1 \(input shape \(1, 4\)\)"):
        retry_if_oom(fn)(x, y)
    assert [b for b, _ in fn.calls] == [2, 1]  # the first half raised: nothing after
    assert all(devs == {"cpu"} for _, devs in fn.calls)  # where the caller put it
    with pytest.raises(torch.OutOfMemoryError, match="Tried to allocate"):
        retry_if_oom(Capped(0))(torch.zeros(1, 4), np.zeros((1, 3)))


def test_batch_axis():
    x = torch.arange(24.0).reshape(2, 6, 2)

    def fn(a):
        if a.shape[1] > 2:
            raise torch.OutOfMemoryError("out of memory")
        return a * 2

    assert torch.equal(retry_if_oom(fn, batch_axis=1)(x), x * 2)


def test_eval_restores_instance_masks_in_halves(monkeypatch):
    """The instance eval restores each selected mask to the original size
    on its own: out of memory above 25 masks, it gives the same instances."""
    from bm2f_tpu_torch import eval as port_eval

    rng = np.random.RandomState(9)
    logits = torch.from_numpy(rng.randn(12, 6).astype(np.float32) * 3)
    masks = torch.from_numpy(rng.randn(12, 24, 24).astype(np.float32) * 2)
    kw = dict(pad_hw=(96, 96), valid_hw=(90, 70), orig_hw=(45, 35), num_classes=5, topk=60)
    want = port_eval.instance_on_device(logits, masks, **kw)
    restore = port_eval._to_original

    def capped(sel, *a):
        if sel.shape[0] > 25:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return restore(sel, *a)

    monkeypatch.setattr(port_eval, "_to_original", capped)
    retry_if_oom.splits = 0
    got = port_eval.instance_on_device(logits, masks, **kw)
    assert retry_if_oom.splits == 3  # 60 -> 30 + 30 -> 15 + 15 + 15 + 15
    for k in want:
        assert torch.equal(got[k], want[k]), k
