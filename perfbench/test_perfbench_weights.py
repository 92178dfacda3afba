"""The draw rules a family's leaf can name (``weights.RULES`` and
``normal``), the float32 a leaf can ask for, and why a Mamba layer
needs them: under the published init a scan that loses its state moves
a row's last position, under ones it does not.  Small, on the CPU."""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

import _testkit as K
import weights as W

CPU = torch.device("cpu")
ARCH = {"n_layers": 4}
N = 16


def _ones(t):
    assert torch.equal(t, torch.ones_like(t))


def _zeros(t):
    assert torch.equal(t, torch.zeros_like(t))


def _s4d_log(t):
    row = torch.log(torch.arange(1, N + 1, dtype=torch.float32))
    assert torch.equal(t, row.to(t.dtype).expand(t.shape))


def _mamba_dt(t):
    dt = F.softplus(t.double())
    tol = 1e-5 if t.dtype == torch.float32 else 2 ** -8 * 7   # |log dt| <= 7
    assert float(dt.min()) >= W.DT_MIN * (1 - tol)
    assert float(dt.max()) <= W.DT_MAX * (1 + tol)
    # log-uniform: the decades below and above 1e-2 hold about as many
    below = float((dt < 1e-2).double().mean())
    assert 0.45 < below < 0.55, below


def _normal(t):
    std = float(t.float().std())
    assert abs(std - 64 ** -0.5) < 0.03 * 64 ** -0.5, std


RULE_CASES = [
    ("ones", W.Leaf((3, N), rule="ones"), _ones),
    ("zeros", W.Leaf((3, N), rule="zeros"), _zeros),
    ("s4d_log", W.Leaf((5, N), rule="s4d_log", layers=(0, 2)), _s4d_log),
    ("mamba_dt", W.Leaf((4096,), rule="mamba_dt", layers=(1, 3)), _mamba_dt),
    ("normal", W.Leaf((64, 128), 64), _normal),
    ("norm_scale", W.Leaf((N,), layers=(0, 1, 2, 3)), _ones),
]


@pytest.mark.parametrize("float32", [False, True])
@pytest.mark.parametrize("name,leaf,check", RULE_CASES,
                         ids=[c[0] for c in RULE_CASES])
def test_each_rule_draws_what_it_names(name, leaf, check, float32):
    """Each rule's values, stacked over the leaf's layers; in the served
    bf16 unless the leaf asks for float32.  A leaf that names no rule and
    has no fan_in is a norm's scale: ones in float32 as before."""
    if float32:
        leaf = dataclasses.replace(leaf, float32=True)
    t = W.make({"x": leaf}, ARCH, {}, K.SEEDS[0], CPU)["x"]
    assert tuple(t.shape) == leaf.stacked
    held_f32 = float32 or (not leaf.rule and not leaf.fan_in)
    assert t.dtype == (torch.float32 if held_f32 else torch.bfloat16)
    check(t)


def _table(first: W.Leaf | None = None) -> dict:
    out = {} if first is None else {"first": first}
    out.update(a=W.Leaf((32, 8), 32, layers=(0, 1)),
               dt=W.Leaf((64,), rule="mamba_dt", float32=True),
               b=W.Leaf((8, 32), 8, resid=True))
    return out


def test_one_seed_draws_the_same_bits():
    one = W.make(_table(), ARCH, {}, K.SEEDS[0], CPU)
    two = W.make(_table(), ARCH, {}, K.SEEDS[0], CPU)
    other = W.make(_table(), ARCH, {}, K.SEEDS[1], CPU)
    for k in one:
        assert torch.equal(one[k], two[k]), k
        assert not torch.equal(one[k], other[k]), k


@pytest.mark.parametrize("rule", ["ones", "zeros", "s4d_log"])
def test_a_rule_that_draws_nothing_shifts_no_other_leaf(rule):
    """Only ``normal`` and ``mamba_dt`` take values from the generator,
    so a leaf of another rule placed first leaves every later leaf's bits
    as they were."""
    base = W.make(_table(), ARCH, {}, K.SEEDS[0], CPU)
    got = W.make(_table(W.Leaf((2, N), rule=rule)), ARCH, {}, K.SEEDS[0],
                 CPU)
    for k in base:
        assert torch.equal(base[k], got[k]), k


@pytest.mark.parametrize("leaf", [W.Leaf((4,), rule="uniform"),
                                  W.Leaf((4,), rule="normal")],
                         ids=["unknown", "normal_without_fan_in"])
def test_a_rule_that_cannot_be_drawn_is_refused(leaf):
    with pytest.raises(ValueError, match="x:"):
        W.make({"x": leaf}, ARCH, {}, K.SEEDS[0], CPU)


# ------------------------------------------- why Mamba needs the rules --

CHUNK = 64
ROWS, LENGTH = 16, 16 * CHUNK


def _mamba_cfg():
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(name="mamba-small", family="hybrid", n_layers=8,
                      d_model=32, n_heads=4, n_kv_heads=4, d_ff=0,
                      vocab_size=256, mixer="mamba_pattern", attn_every=8,
                      attn_offset=4)


def _mamba_table(cfg, published: bool) -> dict:
    """A table of the port's ``mamba_specs(cfg)``: its matrices normal
    with the port's fan-in, and each other leaf by the published init
    (``A_log`` S4D's, ``dt_bias`` Mamba's dt, the conv bias zeros, the
    skip ones; float32 where the port holds it so) or, without
    ``published``, as a table that names no rule draws it: ones in
    float32."""
    from repro_torch.models.mamba import mamba_specs
    out = {}
    for name, spec in mamba_specs(cfg).items():
        f32 = spec.dtype == torch.float32
        if spec.init == "normal":
            out[name] = W.Leaf(spec.shape, spec.fan_in or spec.shape[-2],
                               float32=f32)
        elif published:
            rule = "mamba_dt" if name == "dt_bias" else spec.init
            out[name] = W.Leaf(spec.shape, rule=rule, float32=f32)
        else:
            out[name] = W.Leaf(spec.shape)
    return out


def test_mamba_leaves_hold_to_the_port_spec():
    """Drawn in the served bf16, each leaf has the shape and the very
    dtype of the port's spec: float32 only where the spec asks for it,
    which passes ``system.program_params``'s check (the spec's dtype, or
    float32 standing in for it)."""
    from repro_torch.models.mamba import mamba_specs
    cfg = _mamba_cfg()
    w = W.make(_mamba_table(cfg, True), ARCH, {}, K.SEEDS[0], CPU)
    for name, spec in mamba_specs(cfg).items():
        t = w[name]
        assert tuple(t.shape) == tuple(spec.shape), name
        assert t.dtype == spec.dtype, name


def _last_position_moves(cfg, w) -> dict:
    """How far two broken scans move each row's last output, as a share
    of that position's largest |value|: ``reset``, the SSM state zeroed
    at the start of every chunk (the conv tail carried); ``redrawn``,
    every token before the last chunk drawn anew."""
    from repro_torch.models.mamba import mamba_forward
    gen = torch.Generator().manual_seed(K.SEEDS[0])
    x = torch.randn(ROWS, LENGTH, cfg.d_model, generator=gen)
    with torch.no_grad():
        y, _ = mamba_forward(x, w, cfg, chunk=CHUNK)
        conv = torch.zeros(ROWS, cfg.d_conv - 1, cfg.d_inner)
        for x_c in x.split(CHUNK, dim=1):
            fresh = torch.zeros(ROWS, cfg.d_inner, cfg.d_state)
            reset, state = mamba_forward(x_c, w, cfg, chunk=CHUNK,
                                         state={"conv": conv, "ssm": fresh})
            conv = state["conv"]
        x2 = x.clone()
        x2[:, :-CHUNK] = torch.randn(ROWS, LENGTH - CHUNK, cfg.d_model,
                                     generator=gen)
        redrawn, _ = mamba_forward(x2, w, cfg, chunk=CHUNK)
    last = y[:, -1]
    top = float(last.abs().max())
    return {"reset": float((reset[:, -1] - last).abs().max()) / top,
            "redrawn": float((redrawn[:, -1] - last).abs().max()) / top}


@pytest.mark.parametrize("published", [True, False],
                         ids=["published_init", "ones"])
def test_the_last_position_sees_the_scan_state(published):
    """The port's ``mamba_forward`` over 16 rows of 1024 tokens, chunk
    64, at d_model 32.  Under the published init (S4D's A = -(1..16), dt
    log-uniform in [1e-3, 1e-1]) the slowest channels keep
    exp(-1e-3) = 99.9% of their state a step, so a state zeroed at each
    chunk moves the last position by 12.0% of its largest value on this
    seed (2.9-14.4% over 16 seeds), and the tokens before the last chunk
    drawn anew by 3.4% (1.5-6.8%).  Drawn as ones, A = -e on every
    channel and dt = softplus(u + 1), about 1.3, keep about
    exp(-e * 1.3) = 3% a step: after the last chunk's 61 or more steps
    the old state is some 1e-90 of the new, far below float32's
    rounding, and both breaks read exactly 0.  A prefill cell compares
    only each row's last position, so on ones it could not see a scan
    that drops its state."""
    cfg = _mamba_cfg()
    w = W.make(_mamba_table(cfg, published), ARCH, {}, K.SEEDS[0], CPU,
               torch.float32)
    moved = _last_position_moves(cfg, w)
    if published:
        assert min(moved.values()) >= 0.01, moved
    else:
        assert moved == {"reset": 0.0, "redrawn": 0.0}, moved
