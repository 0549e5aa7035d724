"""The port's data pipeline (``repro_torch.data``, its own copy of the
NumPy-only reference module) gives the reference's bytes: every batch,
every loader shard, every resume; and the reference's own data tests
(``tests/substrate/test_data_optim.py::TestData``) on the port."""
import numpy as np
import pytest

from repro.data import ShardedLoader as RLoader, SyntheticLMDataset as RDataset, make_train_batches as r_batches
from repro_torch.data import ShardedLoader, SyntheticLMDataset, make_train_batches


@pytest.mark.parametrize("vocab,seq,seed,index,batch", [
    (512, 32, 7, 3, 4), (256_000, 64, 1, 0, 1), (51_865, 17, 0, 9, 3), (102_400, 128, 5, 2, 2),
])
def test_batches_are_the_references_bytes(vocab, seq, seed, index, batch):
    a = SyntheticLMDataset(vocab, seq, seed=seed).batch(index, batch)
    b = RDataset(vocab, seq, seed=seed).batch(index, batch)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype == np.int32
        assert a[k].tobytes() == b[k].tobytes()


def test_make_train_batches_is_the_references():
    for a, b in zip(make_train_batches(512, 16, 4, 5, seed=3), r_batches(512, 16, 4, 5, seed=3), strict=True):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_loader_shards_match_the_reference(hosts):
    ds, rds = SyntheticLMDataset(512, 16, seed=2), RDataset(512, 16, seed=2)
    for host in range(hosts):
        ours, ref = ShardedLoader(ds, 8, host, hosts, start_step=3), RLoader(rds, 8, host, hosts, start_step=3)
        try:
            for _ in range(3):
                a, b = next(ours), next(ref)
                assert a["tokens"].tobytes() == b["tokens"].tobytes()
                assert a["labels"].tobytes() == b["labels"].tobytes()
            assert ours.step == ref.step == 6
        finally:
            ours.close()
            ref.close()


def test_loader_rejects_an_uneven_split():
    with pytest.raises(ValueError, match="does not split"):
        ShardedLoader(SyntheticLMDataset(512, 16), global_batch=6, num_hosts=4)


class TestData:
    def test_deterministic_batches(self):
        ds = SyntheticLMDataset(vocab_size=512, seq_len=32, seed=7)
        a, b = ds.batch(3, 4), ds.batch(3, 4)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])

    def test_different_steps_differ(self):
        ds = SyntheticLMDataset(vocab_size=512, seq_len=32, seed=7)
        assert not np.array_equal(ds.batch(0, 4)["tokens"], ds.batch(1, 4)["tokens"])

    def test_host_sharding_partitions_global_batch(self):
        ds = SyntheticLMDataset(vocab_size=512, seq_len=16, seed=0)
        full = ds.batch(0, 8)
        parts = []
        for host in range(4):
            loader = ShardedLoader(ds, global_batch=8, host_index=host, num_hosts=4)
            parts.append(next(loader)["tokens"])
            loader.close()
        np.testing.assert_array_equal(np.concatenate(parts), full["tokens"])

    def test_loader_resumes_at_step(self):
        ds = SyntheticLMDataset(vocab_size=512, seq_len=16, seed=0)
        loader = ShardedLoader(ds, global_batch=4, start_step=5)
        got = next(loader)["tokens"]
        loader.close()
        assert not loader._thread.is_alive()
        np.testing.assert_array_equal(got, ds.batch(5, 4)["tokens"])
