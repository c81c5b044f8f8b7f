"""The port's data pipeline, held to the reference byte for byte.

``repro_torch.data.pipeline`` is the port's own copy of the reference's
numpy pipeline: for every source (synthetic tokens, frame and patch
extras, a token file), every host slice and every step, its batches must
be the reference's arrays exactly (keys, dtypes, shapes and bytes). The
reference's own properties (``tests/test_data.py`` and
``test_pipeline_determinism`` of ``tests/test_train.py``) run on the port.
"""
import numpy as np
import pytest

from repro.data import pipeline as ref
from repro_torch.data import pipeline as port


def _same(got: dict, want: dict) -> bool:
    return (sorted(got) == sorted(want) and all(
        got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        and got[k].tobytes() == want[k].tobytes() for k in want))


CONFIGS = {
    "synthetic": dict(vocab_size=151936, seq_len=33, global_batch=4,
                      seed=5),
    "frames": dict(vocab_size=512, seq_len=16, global_batch=4, seed=1,
                   frontend="frames", d_model=24),
    "patches": dict(vocab_size=512, seq_len=16, global_batch=4, seed=1,
                    frontend="patches", frontend_tokens=4, d_model=24),
}


@pytest.mark.parametrize("kind", sorted(CONFIGS))
@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_batches_match_reference(kind, hosts):
    kw = CONFIGS[kind]
    for index in range(hosts):
        got = port.make_pipeline(port.DataConfig(**kw), index, hosts)
        want = ref.make_pipeline(ref.DataConfig(**kw), index, hosts)
        assert type(got).__name__ == type(want).__name__ == "SyntheticLM"
        assert got.local_batch == want.local_batch == kw["global_batch"] // hosts
        for step in (0, 1, 7, 1000):
            assert _same(got.batch_at(step), want.batch_at(step))
        it = iter(got)
        assert _same(next(it), want.batch_at(0))
        assert _same(next(it), want.batch_at(1))


@pytest.mark.parametrize("hosts", [1, 2])
def test_file_batches_match_reference(tmp_path, hosts):
    tokens = np.random.default_rng(0).integers(0, 1 << 20, 10_000,
                                               dtype=np.uint32)
    path = tmp_path / "toks.bin"
    tokens.tofile(path)
    kw = dict(vocab_size=1000, seq_len=16, global_batch=4, seed=2,
              kind="file", path=str(path))
    for index in range(hosts):
        got = port.make_pipeline(port.DataConfig(**kw), index, hosts)
        want = ref.make_pipeline(ref.DataConfig(**kw), index, hosts)
        assert type(got).__name__ == type(want).__name__ == "FileLM"
        for step in (0, 3, 99):
            batch = got.batch_at(step)
            assert _same(batch, want.batch_at(step))
            assert batch["tokens"].shape == (4 // hosts, 16)
            # labels are next-token shifted views of the same window
            assert (batch["labels"][:, :-1] == batch["tokens"][:, 1:]).all()


def test_refusals_match_reference():
    with pytest.raises(ValueError, match="process count"):
        port.make_pipeline(port.DataConfig(vocab_size=8, seq_len=4,
                                           global_batch=6), 0, 4)
    with pytest.raises(ValueError, match="cfg.path"):
        port.make_pipeline(port.DataConfig(vocab_size=8, seq_len=4,
                                           global_batch=4, kind="file"))
    assert port.DataConfig(vocab_size=8, seq_len=4, global_batch=4) \
        .__dict__ == ref.DataConfig(vocab_size=8, seq_len=4,
                                    global_batch=4).__dict__


def test_host_slices_are_distinct_and_sized():
    cfg = port.DataConfig(vocab_size=50, seq_len=8, global_batch=8, seed=1)
    parts = [port.make_pipeline(cfg, process_index=i,
                                process_count=4).batch_at(3)
             for i in range(4)]
    assert all(p["tokens"].shape == (2, 8) for p in parts)
    assert len({p["tokens"].tobytes() for p in parts}) == 4


def test_pipeline_determinism():
    cfg = port.DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=3)
    a = port.make_pipeline(cfg).batch_at(7)
    b = port.make_pipeline(cfg).batch_at(7)
    assert (a["tokens"] == b["tokens"]).all()
    c = port.make_pipeline(cfg).batch_at(8)
    assert not (a["tokens"] == c["tokens"]).all()
    assert a["tokens"].dtype == np.int32
