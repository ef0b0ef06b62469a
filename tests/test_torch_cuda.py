"""The CUDA decode kernel and the port's engine on a GPU (marker ``cuda``).

Skipped without a CUDA device. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernel is held against its plain PyTorch version on the same CUDA
inputs at atol = rtol = 1e-2 on the f32 output (sums in another order; an
f32-ulp difference can flip the bf16 rounding of one probability), and
parked lanes must be exact zeros.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.policy import get_policy
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import dispatch
from repro_torch.models import registry as R
from repro_torch.serve.decode import generate
from repro_torch.serve.engine import Engine

pytestmark = pytest.mark.cuda
TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, *, B=4, Sc=40, Hkv=2, G=2, D=32, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Sc, Hkv, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Sc, Hkv, D), generator=g, device=dev).to(dtype)
    q_pos = torch.randint(0, Sc, (B,), generator=g, device=dev, dtype=torch.int32)
    cells = torch.arange(Sc, device=dev, dtype=torch.int32)[None, :]
    k_pos = torch.where(cells <= q_pos[:, None], cells, -1).to(torch.int32)
    return q, k, v, k_pos, q_pos


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [dict(Sc=40, G=2, D=32), dict(Sc=300, G=8, D=128),
                                   dict(Sc=17, G=5, D=64)])
@pytest.mark.parametrize("kw", [{}, dict(window=7, softcap=30.0)])
def test_kernel_matches_plain(cuda, dtype, shape, kw):
    q, k, v, k_pos, q_pos = _inputs(cuda, dtype=dtype, **shape)
    q_pos[1] = -1                                          # a parked lane
    before = DA.LAUNCHES
    got = DA.fused_decode_attention(q, k, v, k_pos, q_pos, p_dtype=dtype, **kw)
    want = DA.decode_attention_ref(q, k, v, k_pos, q_pos, p_dtype=dtype, **kw)
    torch.cuda.synchronize()
    assert DA.LAUNCHES == before + 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool((got[1] == 0).all())
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_kernel_rejects_what_it_cannot_take(cuda):
    q, k, v, k_pos, q_pos = _inputs(cuda, Sc=8000, G=8, D=128)
    with pytest.raises(ValueError, match="shared memory"):
        DA.fused_decode_attention(q, k, v, k_pos, q_pos)
    q, k, v, k_pos, q_pos = _inputs(cuda)
    with pytest.raises(ValueError, match="int32"):
        DA.fused_decode_attention(q, k, v, k_pos.long(), q_pos)
    with pytest.raises(ValueError, match="dtype"):
        DA.fused_decode_attention(q.half(), k.half(), v.half(), k_pos, q_pos)


def test_engine_matches_generate_on_the_card(cuda):
    policy = get_policy("bf16_standard")
    cfg = R.get_config("qwen2.5-3b").reduced()
    params = R.init(cfg, 0, policy.param_dtype)
    eng = Engine(params, cfg, policy, n_slots=3, max_len=24, fused_decode=True)
    rng = np.random.default_rng(0)
    for s, g in zip((5, 7, 5, 7, 5), (8, 6, 8, 6, 8)):
        eng.submit(rng.integers(0, cfg.vocab, size=s), g)
    before = DA.LAUNCHES
    done = eng.run()
    assert DA.LAUNCHES - before == cfg.n_layers * eng.stats.steps
    groups = {}
    for c in done:
        groups.setdefault((c.prompt.size, c.tokens.size), []).append(c)
    with dispatch.fused_decode():
        for (s0, gen), cs in groups.items():
            rows = [c.prompt for c in cs] + [np.zeros(s0, np.int32)] * (3 - len(cs))
            ref = generate(params, cfg, policy, np.stack(rows), max_new_tokens=gen,
                           cache_len=24).cpu().numpy()
            for i, c in enumerate(cs):
                assert np.array_equal(ref[i, s0:], c.tokens)
