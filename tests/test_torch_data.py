"""The port's synthetic data pipeline against the JAX package's: the same
bytes for the same (seed, step), modality stubs included."""

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-370m", "phi-3-vision-4.2b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (3, 1), (11, 42)])
def test_make_batch_is_byte_identical(arch, seed, step):
    """phi-3-vision adds ``patches`` (n_patches), seamless ``frames``
    (frame_input)."""
    seq = 40
    mine = syn.make_batch(configs.get_smoke(arch), seq, 4, step=step, seed=seed)
    theirs = jsyn.make_batch(jconfigs.get_smoke(arch), seq, 4, step=step, seed=seed)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype and mine[k].shape == theirs[k].shape, k
        assert mine[k].tobytes() == theirs[k].tobytes(), k
    cfg = configs.get_smoke(arch)
    assert ("patches" in mine) == bool(cfg.n_patches)
    assert ("frames" in mine) == bool(cfg.frame_input)


def test_host_shards_are_byte_identical():
    mine = syn.SyntheticLM(1000, 16, 8, seed=3)
    theirs = jsyn.SyntheticLM(1000, 16, 8, seed=3)
    for host in range(2):
        a = mine.batch(5, host_index=host, host_count=2)
        b = theirs.batch(5, host_index=host, host_count=2)
        assert all(a[k].tobytes() == b[k].tobytes() for k in b)
