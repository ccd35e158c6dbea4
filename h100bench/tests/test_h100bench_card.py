"""On the card, at the cells' own size: the program's readings within each
limit and every lower-precision control past one, on three seeds. Run
there with ``python -m pytest -m cuda h100bench/tests`` (about 3 minutes a
cell); skipped without a card."""

import pytest

from h100bench import harness

CELLS = [w["name"] for w in harness.bench_file()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_sound_within_limits_and_controls_past_them(card, cell):
    from h100bench.calibrate import readings

    ctx = harness.make_context(cell, 0, 0.0, False, 0.0)
    limits = ctx.traffic["limits"]
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        sound, controls = readings(cell, seed, control=True)
        assert all(sound[k] <= v for k, v in limits.items()), (seed, sound)
        for kind, got in controls.items():
            assert any(got[k] > v for k, v in limits.items()), (kind, got)
