"""The control comes out not correct: the plain reference put in the
program's place in fp8 (every matrix product's operands rounded to
float8 e4m3), each cell small on the CPU, against the cell's own
limits, while the program at the same size passes them.  For the swap
tier the control is a reload of a bf16 checkpoint rounded to fp8 and
back, and the comparison is exact."""
import pytest
import torch

import _testkit as K
import control
import drivers

SERVED = [c["name"] for c in K.cells() if c["traffic"] != "swap"]
#: wider than the other tests' small size, with the configuration's own
#: head width, and more positions compared, so that the control's
#: reading comes near its reading at full size
WIDER = {"n_layers": 8, "d_model": 256, "n_heads": 4, "d_ff": 512,
         "vocab_size": 8192}
MORE = {"prefill": {"tokens_per_batch": 1024, "lengths": [32, 64, 128]},
        "decode": {"prompt_len": 16, "cache_len": 80, "compare_sequences": 4}}


@pytest.fixture
def one_thread():
    """One intra-op thread, so that a loaded machine still completes a
    decode window's first generation (64 steps) in a few seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", K.SEEDS)
@pytest.mark.parametrize("workload", SERVED)
def test_control_fails_where_the_program_passes(workload, seed, one_thread):
    c = K.ctx(workload, seed=seed, seconds=4.0, control=True)
    full = K.harness.config_file(K.harness.bench(), c.config["name"])
    c.config["arch"].update(WIDER, head_dim=full["arch"]["head_dim"])
    c.traffic.update(MORE[c.traffic["driver"]])
    out = drivers.DRIVERS[c.traffic["driver"]](c)
    assert out.correct, out.compared
    failed = {k: out.records[f"control_{k}"] for k, lim in c.limits.items()
              if out.records[f"control_{k}"] > lim}
    assert failed, (c.limits, out.records)


def test_fp8_reload_changes_the_bytes():
    gen = torch.Generator()
    gen.manual_seed(K.SEEDS[0])
    payload = torch.randn(1 << 16, generator=gen).to(torch.bfloat16)
    raw = payload.view(torch.uint8)
    assert control.fp8_roundtrip_differ(raw) > 0
    exact = torch.zeros(1 << 17, dtype=torch.uint8)
    assert control.fp8_roundtrip_differ(exact) == 0
