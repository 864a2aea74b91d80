"""The data path of diamond_tpu_torch against the JAX package's (diamond_tpu/data), on the
CPU: episodes and datasets written by either package and read by the other, segments,
the host collate, the sampler's segment ids from the same generator state, the device
store's batches (the cases of tests/test_device_store.py without a mesh, on CPU
tensors) against the JAX host collate and the JAX store, the traverser, and the
classification metrics. Every comparison is exact: the data path copies and gathers,
it computes nothing.
"""

import numpy as np
import pytest
import torch

from diamond_tpu import utils as jutils
from diamond_tpu.data import (BatchSampler as JBatchSampler, Dataset as JDataset,
                              DatasetTraverser as JTraverser, Episode as JEpisode,
                              SegmentId as JSegmentId)
from diamond_tpu.data.device_store import DeviceEpisodeStore as JStore
from diamond_tpu.data.segment import (collate_segments_to_batch as j_collate,
                                      make_segment as j_make_segment)
from diamond_tpu_torch import utils
from diamond_tpu_torch.data.batch_sampler import BatchSampler
from diamond_tpu_torch.data.dataset import Dataset
from diamond_tpu_torch.data.device_store import DeviceEpisodeStore, StoreBatchIterator
from diamond_tpu_torch.data.episode import Episode
from diamond_tpu_torch.data.segment import (DeviceBatch, SegmentId, collate_segments_to_batch,
                                            make_segment)
from diamond_tpu_torch.data.traverser import DatasetTraverser

H = W = 8
FIELDS = ("obs", "act", "rew", "end", "trunc", "mask_padding", "final_obs", "has_final_obs")


def make_ep(rng, t, with_final=True, alive=False, cls=Episode):
    info = {}
    if with_final:
        info["final_observation"] = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    end = np.zeros(t, np.uint8)
    if not alive:
        end[-1] = 1
    return cls(obs=rng.integers(0, 255, (t, H, W, 3), dtype=np.uint8),
               act=rng.integers(0, 4, t).astype(np.int32),
               rew=rng.choice([-1.0, 0.0, 0.5, 2.0], t).astype(np.float32),
               end=end, trunc=np.zeros(t, np.uint8), info=info)


def as_jax(ep):
    return JEpisode(obs=ep.obs, act=ep.act, rew=ep.rew, end=ep.end, trunc=ep.trunc,
                    info=dict(ep.info))


def host_batch(dataset, ids):
    return DeviceBatch.from_batch(collate_segments_to_batch([dataset[sid] for sid in ids]),
                                  "cpu")


def assert_batches_equal(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype, (name, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=name)


def both_datasets(tmp_path, lengths, seed, with_final=lambda t: True):
    """The same episodes in a port Dataset and a JAX one."""
    rng = np.random.default_rng(seed)
    ds, jds = Dataset(tmp_path / "p", "p"), JDataset(tmp_path / "j", "j")
    for t in lengths:
        ep = make_ep(rng, t, with_final=with_final(t))
        ds.add_episode(ep)
        jds.add_episode(as_jax(ep))
    return ds, jds


# ---------------------------------------------------------------------------
# Episodes, segments, the host collate


def test_episode_files_cross_between_packages(tmp_path):
    rng = np.random.default_rng(0)
    ep = make_ep(rng, 10)
    ep.save(tmp_path / "p.npz")
    j = JEpisode.load(tmp_path / "p.npz")
    as_jax(ep).save(tmp_path / "j.npz")
    back = Episode.load(tmp_path / "j.npz")
    for e in (j, back):
        for k in ("obs", "act", "rew", "end", "trunc"):
            np.testing.assert_array_equal(getattr(e, k), getattr(ep, k))
            assert getattr(e, k).dtype == getattr(ep, k).dtype
        np.testing.assert_array_equal(e.info["final_observation"], ep.info["final_observation"])
    assert back.compute_metrics() == j.compute_metrics() == {"length": 10,
                                                             "return": float(ep.rew.sum())}


def test_episode_concat_and_dead():
    rng = np.random.default_rng(1)
    a = make_ep(rng, 4, with_final=False, alive=True)
    b = make_ep(rng, 6)
    ab, jab = a + b, as_jax(a) + as_jax(b)
    assert len(ab) == 10 and ab.dead.sum() == 1
    np.testing.assert_array_equal(ab.obs, jab.obs)
    np.testing.assert_array_equal(ab.info["final_observation"], jab.info["final_observation"])
    with pytest.raises(ValueError, match="ended"):
        ab + b


@pytest.mark.parametrize("sid", [(0, 3, 8), (0, -3, 4), (0, 6, 14), (0, -2, 12), (0, 9, 10)],
                         ids=["interior", "left", "right", "both", "last"])
def test_make_segment_matches_jax(sid):
    ep = make_ep(np.random.default_rng(2), 10)
    s, js = make_segment(ep, SegmentId(*sid)), j_make_segment(as_jax(ep), JSegmentId(*sid))
    for k in ("obs", "act", "rew", "end", "trunc", "mask_padding"):
        np.testing.assert_array_equal(getattr(s, k), getattr(js, k), err_msg=k)
    assert (s.id.start, s.id.stop, s.effective_size) == (js.id.start, js.id.stop,
                                                         js.effective_size)
    with pytest.raises(ValueError):
        make_segment(ep, SegmentId(0, 10, 12))


def test_collate_matches_jax():
    rng = np.random.default_rng(3)
    eps = [make_ep(rng, 10), make_ep(rng, 7, with_final=False), make_ep(rng, 12)]
    ids = [(0, -2, 5), (1, 3, 10), (2, 8, 15)]
    b = collate_segments_to_batch([make_segment(e, SegmentId(*i)) for e, i in zip(eps, ids)])
    jb = j_collate([j_make_segment(as_jax(e), JSegmentId(*i)) for e, i in zip(eps, ids)])
    assert_batches_equal(b, jb)
    np.testing.assert_array_equal(b.has_final_obs, [True, False, True])
    assert [(s.start, s.stop) for s in b.segment_ids] == [(0, 5), (3, 7), (8, 12)]
    db = DeviceBatch.from_batch(b, "cpu")
    assert db.obs.dtype == torch.uint8 and db.act.dtype == torch.int32
    assert db.mask_padding.dtype == torch.bool and db.final_obs.shape == (3, H, W, 3)


# ---------------------------------------------------------------------------
# Dataset and sampler


def test_dataset_written_by_jax_reads_in_the_port(tmp_path):
    rng = np.random.default_rng(4)
    jds = JDataset(tmp_path / "train", "train_dataset")
    ep = make_ep(rng, 6, with_final=False, alive=True, cls=JEpisode)
    eid = jds.add_episode(ep)
    jds.add_episode(ep + make_ep(rng, 4, cls=JEpisode), episode_id=eid)  # extended in place
    jds.add_episode(make_ep(rng, 5, cls=JEpisode))
    jds.add_episode(make_ep(rng, 1234 % 7 + 3, cls=JEpisode))
    jds.save_to_default_path()

    ds = Dataset(tmp_path / "train", "train_dataset")
    ds.load_from_default_path()
    for k, v in jds.state_dict().items():
        np.testing.assert_array_equal(ds.state_dict()[k], v, err_msg=k)
    assert (ds.counts_rew, ds.counts_end) == (jds.counts_rew, jds.counts_end)
    for sid in [(0, -2, 6), (0, 7, 12), (1, 0, 5), (2, 1, 4)]:
        s, js = ds[SegmentId(*sid)], jds[JSegmentId(*sid)]
        np.testing.assert_array_equal(s.obs, js.obs)
        np.testing.assert_array_equal(s.mask_padding, js.mask_padding)
    assert ds._get_episode_path(1234).parts[-4:] == ("200", "30", "4", "1234.npz")


def test_dataset_written_by_the_port_reads_in_jax(tmp_path):
    rng = np.random.default_rng(5)
    ds = Dataset(tmp_path / "train", cache_in_ram=True)
    ep = make_ep(rng, 6, with_final=False, alive=True)
    eid = ds.add_episode(ep)
    ds.add_episode(ep + make_ep(rng, 3), episode_id=eid)
    ds.add_episode(make_ep(rng, 8))
    assert (ds.num_episodes, ds.num_steps, len(ds)) == (2, 17, 17)
    np.testing.assert_array_equal(ds.start_idx, [0, 9])
    ds.save_to_default_path()
    jds = JDataset(tmp_path / "train")
    jds.load_from_default_path()
    for k, v in ds.state_dict().items():
        np.testing.assert_array_equal(jds.state_dict()[k], v, err_msg=k)
    np.testing.assert_array_equal(jds.load_episode(0).obs, ds.load_episode(0).obs)
    ds.is_static = True
    with pytest.raises(RuntimeError, match="static"):
        ds.add_episode(make_ep(rng, 3))


@pytest.mark.parametrize("weights,beyond,rank,world", [
    ([0.1, 0.1, 0.1, 0.7], False, 0, 1), ([0.1, 0.1, 0.1, 0.7], True, 0, 1),
    (None, False, 0, 1), ([0.1, 0.1, 0.1, 0.7], True, 1, 2), ([0.5, 0.5], False, 0, 1)],
    ids=["weights", "beyond-end", "by-length", "rank-1-of-2", "two-buckets"])
def test_sampler_draws_the_jax_ids(tmp_path, weights, beyond, rank, world):
    """The same generator state draws the same SegmentIds; three and nine episodes
    (fewer and more than buckets)."""
    for n in (3, 9):
        ds, jds = both_datasets(tmp_path / str(n), [10 + 3 * i for i in range(n)], 6)
        s = BatchSampler(ds, rank, world, 16, 5, weights, beyond, seed=7)
        js = JBatchSampler(jds, rank, world, 16, 5, weights, beyond, seed=7)
        for _ in range(4):
            ids, jids = s.sample(), js.sample()
            assert [(i.episode_id, i.start, i.stop) for i in ids] == \
                [(i.episode_id, i.start, i.stop) for i in jids]
        gen = np.random.default_rng(11)
        s.rng, js.rng = gen, np.random.default_rng(11)
        assert s.sample() == [SegmentId(i.episode_id, i.start, i.stop) for i in js.sample()]


# ---------------------------------------------------------------------------
# The device store (tests/test_device_store.py without a mesh, on CPU tensors)


def store(capacity, max_episodes=4096):
    return DeviceEpisodeStore(capacity, (H, W, 3), max_episodes, device="cpu")


def test_store_matches_host_collate_and_the_jax_store(tmp_path):
    ds, jds = both_datasets(tmp_path, (20, 13, 31), 0, with_final=lambda t: t != 13)
    st, jst = store(512), JStore(512, (H, W, 3))
    st.sync(ds)
    jst.sync(jds)
    ids = [SegmentId(0, 3, 11), SegmentId(1, -5, 3), SegmentId(2, 28, 36), SegmentId(1, 5, 13)]
    got = st.make_batch(ids)
    assert_batches_equal(got, host_batch(ds, ids))
    assert_batches_equal(got, jst.make_batch([JSegmentId(*(s.episode_id, s.start, s.stop))
                                               for s in ids]))
    assert_batches_equal(got, j_collate([jds[JSegmentId(s.episode_id, s.start, s.stop)]
                                         for s in ids]))


def test_store_extension_and_relocation(tmp_path):
    rng = np.random.default_rng(1)
    ds = Dataset(tmp_path / "ds", "ds")
    e0 = make_ep(rng, 10, with_final=False, alive=True)
    ds.add_episode(e0)
    st = store(512)
    st.sync(ds)
    e0 = e0 + make_ep(rng, 6, with_final=True, alive=True)  # the tail grows in place
    ds.add_episode(e0, episode_id=0)
    st.sync(ds)
    ids = [SegmentId(0, 8, 16)]
    assert_batches_equal(st.make_batch(ids), host_batch(ds, ids))
    assert st.waste_steps == 0
    ds.add_episode(make_ep(rng, 12))
    st.sync(ds)
    e0 = e0 + make_ep(rng, 4, with_final=True)  # now below the tail: relocated
    ds.add_episode(e0, episode_id=0)
    st.sync(ds)
    assert st.waste_steps == 16
    ids = [SegmentId(0, 12, 20), SegmentId(1, 0, 8)]
    assert_batches_equal(st.make_batch(ids), host_batch(ds, ids))


def test_store_iterator_matches_sampling(tmp_path):
    ds, _ = both_datasets(tmp_path, (25, 40, 17, 30), 2)
    st = store(512)
    st.sync(ds)
    s1 = BatchSampler(ds, 0, 1, 4, 6, [0.1, 0.1, 0.1, 0.7], True, seed=7)
    s2 = BatchSampler(ds, 0, 1, 4, 6, [0.1, 0.1, 0.1, 0.7], True, seed=7)
    it = iter(StoreBatchIterator(st, s1))
    for _ in range(3):
        assert_batches_equal(next(it), host_batch(ds, s2.sample()))


def test_store_ic_gather(tmp_path):
    ds, _ = both_datasets(tmp_path, (25, 30), 3)
    st = store(128)
    st.sync(ds)
    obs, act = st.gather_ic([SegmentId(0, 2, 6), SegmentId(1, 10, 14)])
    assert obs.shape == (2, 4, H, W, 3) and obs.dtype == torch.uint8
    np.testing.assert_array_equal(obs[0].numpy(), ds.load_episode(0).obs[2:6])
    np.testing.assert_array_equal(act[1].numpy(), ds.load_episode(1).act[10:14])


def test_store_overflow_raises(tmp_path):
    ds, _ = both_datasets(tmp_path, (40,), 4)
    with pytest.raises(RuntimeError, match="overflow"):
        store(32).sync(ds)
    with pytest.raises(RuntimeError, match="max_episodes"):
        store(512, max_episodes=0).sync(ds)


def test_store_compaction_reclaims_orphans(tmp_path):
    """Growing the non-tail episode again and again orphans its old regions; once the
    waste would overflow the ring, sync compacts on the device and goes on (capacity 140
    against ~250 steps uploaded), and the batches still equal the host's."""
    rng = np.random.default_rng(7)
    ds = Dataset(tmp_path / "ds", "ds")
    eps = [make_ep(rng, 30, with_final=False, alive=True),
           make_ep(rng, 20, with_final=False, alive=True)]
    for e in eps:
        ds.add_episode(e)
    st = store(140)
    st.sync(ds)
    for _ in range(2):
        for ep_id in (0, 1):
            eps[ep_id] = eps[ep_id] + make_ep(rng, 10, with_final=False, alive=True)
            ds.add_episode(eps[ep_id], episode_id=ep_id)
            st.sync(ds)
    assert st.compactions >= 1 and st.next_free <= st.capacity
    ids = [SegmentId(0, 45, 53), SegmentId(1, 5, 13), SegmentId(0, -3, 5)]
    assert_batches_equal(st.make_batch(ids), host_batch(ds, ids))
    ds.add_episode(make_ep(rng, 200))
    with pytest.raises(RuntimeError, match="overflow"):
        st.sync(ds)


def test_store_compaction_drops_doomed_region(tmp_path):
    """A non-tail episode that grows with no waste yet: its own region is doomed, so the
    pack reclaims it in the same gather (capacity 20 holds 8 + 8 and a 12-step ep0 only
    that way)."""
    rng = np.random.default_rng(11)
    ds = Dataset(tmp_path / "ds", "ds")
    eps = [make_ep(rng, 8, with_final=False, alive=True),
           make_ep(rng, 8, with_final=False, alive=True)]
    for e in eps:
        ds.add_episode(e)
    st = store(20)
    st.sync(ds)
    eps[0] = eps[0] + make_ep(rng, 4, with_final=False, alive=True)
    ds.add_episode(eps[0], episode_id=0)
    st.sync(ds)
    assert st.compactions == 1 and st.next_free == 20 and st.waste_steps == 0
    ids = [SegmentId(0, 2, 10), SegmentId(1, 0, 8), SegmentId(0, 4, 12)]
    assert_batches_equal(st.make_batch(ids), host_batch(ds, ids))


def test_store_grow_top_episode_appends_suffix(tmp_path):
    """The top live episode growing into the free tail appends its new steps only, with
    no pack."""
    rng = np.random.default_rng(12)
    ds = Dataset(tmp_path / "ds", "ds")
    eps = [make_ep(rng, 8, with_final=False, alive=True),
           make_ep(rng, 8, with_final=False, alive=True)]
    for e in eps:
        ds.add_episode(e)
    st = store(24)
    st.sync(ds)
    eps[0] = eps[0] + make_ep(rng, 2, with_final=False, alive=True)
    ds.add_episode(eps[0], episode_id=0)
    st.sync(ds)  # [ep1 (8)][ep0 (10)], 6 free
    assert int(st.ep_offset[0]) > int(st.ep_offset[1])
    eps[0] = eps[0] + make_ep(rng, 6, with_final=False, alive=True)
    ds.add_episode(eps[0], episode_id=0)
    before = st.compactions
    st.sync(ds)
    assert st.compactions == before and int(st.ep_len[0]) == 16 and st.next_free == 24
    ids = [SegmentId(0, 8, 16), SegmentId(1, 0, 8)]
    assert_batches_equal(st.make_batch(ids), host_batch(ds, ids))


# ---------------------------------------------------------------------------
# Traverser


@pytest.mark.parametrize("pad", [True, False])
def test_traverser_matches_jax_and_the_store(tmp_path, pad):
    """The port's traverser gives the JAX traverser's batches; its index form gathered
    by the store gives the same batch on every real entry and the same masks
    everywhere."""
    ds, jds = both_datasets(tmp_path, (23, 9, 31, 2), 6)  # 31 % 6 == 1: a one-step tail
    st = store(256)
    st.sync(ds)
    trav, jtrav = DatasetTraverser(ds, 3, 6, pad), JTraverser(jds, 3, 6, pad)
    batches, jbatches = list(trav), list(jtrav)
    id_batches = list(trav.iter_batches_ids())
    assert len(batches) == len(jbatches) == len(id_batches) == len(trav) == len(jtrav)
    for b, jb, (ids, masked) in zip(batches, jbatches, id_batches):
        assert_batches_equal(b, jb)
        dev = st.make_batch(ids, masked)
        hdb = DeviceBatch.from_batch(b, "cpu")
        assert torch.equal(dev.mask_padding, hdb.mask_padding)
        real = ~torch.tensor(masked)
        for name in FIELDS:
            assert torch.equal(getattr(dev, name)[real], getattr(hdb, name)[real]), name


# ---------------------------------------------------------------------------
# Classification metrics


def test_confusion_matrix_and_classification_metrics_match_jax():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(4, 6, 3)).astype(np.float32)
    targets = rng.integers(0, 3, (4, 6))
    weights = (rng.random((4, 6)) < 0.8).astype(np.float32)
    cm = utils.multiclass_confusion_matrix(torch.from_numpy(logits), torch.from_numpy(targets),
                                           3, torch.from_numpy(weights))
    cm_j = np.asarray(jutils.multiclass_confusion_matrix(logits, targets, 3, weights))
    np.testing.assert_array_equal(cm.numpy(), cm_j)
    assert cm.sum().item() == weights.sum()
    for a, b in zip(utils.compute_classification_metrics(cm.numpy()),
                    jutils.compute_classification_metrics(cm_j)):
        np.testing.assert_array_equal(a, b)
    logs = [{"confusion_matrix": {"rew": cm, "end": cm[:2, :2]}, "loss": 1.0},
            {"confusion_matrix": {"rew": cm, "end": cm[:2, :2]}}]
    jlogs = [{"confusion_matrix": {"rew": cm_j, "end": cm_j[:2, :2]}, "loss": 1.0},
             {"confusion_matrix": {"rew": cm_j, "end": cm_j[:2, :2]}}]
    utils.process_confusion_matrices_if_any_and_compute_classification_metrics(logs)
    jutils.process_confusion_matrices_if_any_and_compute_classification_metrics(jlogs)
    assert logs == jlogs and len(logs) == 3 and "confusion_matrix" not in logs[0]


def test_legacy_state_dict_loads_in_both_packages(tmp_path):
    """The older state dicts carried Counters (counter_rew/counter_end) and no is_static
    flag (tests/test_data.py's case): both packages load them with the same counts."""
    from collections import Counter

    sd = {"start_idx": np.array([0, 10]), "lengths": np.array([10, 7]),
          "counter_rew": Counter({-1: 3, 0: 12, 1: 2}), "counter_end": Counter({0: 15, 1: 2})}
    ds, jds = Dataset(tmp_path / "p", "p"), JDataset(tmp_path / "j", "j")
    ds.load_state_dict(dict(sd))
    jds.load_state_dict(dict(sd))
    for d in (ds, jds):
        assert d.num_episodes == 2 and d.num_steps == 17
        assert d.counts_rew == [3, 12, 2] and d.counts_end == [15, 2]
        assert not d.is_static
    assert ds.state_dict().keys() == jds.state_dict().keys()
    for k, v in ds.state_dict().items():
        np.testing.assert_array_equal(v, jds.state_dict()[k], err_msg=k)
