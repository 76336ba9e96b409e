"""The port's LM token pipeline (`repro_torch.data.loader`, and
`launch.train.batch_at`) against the reference's, integer for integer.

`markov_batch` (the seeded order-1 Markov chain: its table from the
table seed, its trajectories from (table seed, step)), the
`lm_token_batches` stream and `ShardedBatcher` (pods static, lanes
re-dealt each epoch) are numpy in both packages and must give the same
integers; `batch_at` the same tokens, labels and seeded frames or
patches.  Exact equality throughout.  CPU seconds: about 6.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import get_smoke as ref_smoke  # noqa: E402
from repro.data import loader as ref  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import loader  # noqa: E402
from repro_torch.launch import train  # noqa: E402


@pytest.mark.parametrize("vocab,batch,seq,seed,step", [
    (256, 2, 16, 0, 0), (256, 4, 33, 0, 7), (49152, 3, 64, 5, 2),
    (97, 1, 1, 11, 123)])
def test_markov_batch_is_the_reference(vocab, batch, seq, seed, step):
    got = loader.markov_batch(vocab, batch, seq, table_seed=seed, step=step)
    want = ref.markov_batch(vocab, batch, seq, table_seed=seed, step=step)
    for key in ("tokens", "labels"):
        assert got[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["tokens"][:, 1:],
                                  got["labels"][:, :-1])


def test_token_stream_is_the_reference():
    got = list(loader.lm_token_batches(300, 2, 9, seed=3, steps=4))
    want = list(ref.lm_token_batches(300, 2, 9, seed=3, steps=4))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
    endless = loader.lm_token_batches(300, 2, 9, seed=3)
    for g, w in zip(itertools.islice(endless, 4), want):
        np.testing.assert_array_equal(g["labels"], w["labels"])


@pytest.mark.parametrize("n,gb,pods,lanes,seed", [
    (64, 8, 1, 1, 0), (96, 12, 2, 3, 4), (100, 8, 4, 2, 9)])
def test_sharded_batcher_is_the_reference(n, gb, pods, lanes, seed):
    got = loader.ShardedBatcher(n, gb, pods=pods, lanes=lanes, seed=seed)
    want = ref.ShardedBatcher(n, gb, pods=pods, lanes=lanes, seed=seed)
    for epoch in range(3):
        np.testing.assert_array_equal(got.epoch_order(epoch),
                                      want.epoch_order(epoch))
        gs, ws = list(got.batches(epoch)), list(want.batches(epoch))
        assert len(gs) == len(ws) > 0
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        loader.ShardedBatcher(n, gb + 1, pods=pods, lanes=lanes + 1)


@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-base",
                                  "phi-3-vision-4.2b"])
def test_batch_at_is_the_reference(arch):
    got = train.batch_at(get_smoke(arch), 2, 12, 3, seed=1, device="cpu")
    want = ref_train.batch_at(ref_smoke(arch), 2, 12, 3, seed=1)
    assert set(got) == set(want)
    for key, t in got.items():
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[key]))
