"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  This file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from equss_tpu_torch.ops import quantizer as tq
from equss_tpu_torch.ops.attention import (
    attention_qkv,
    attention_qkv_reference,
    attention_test_input,
    fused_attention,
    fused_attention_reference,
)
from equss_tpu_torch.ops.layernorm import (
    add_layernorm_reference,
    fused_add_layernorm,
    fused_layernorm,
    layernorm_reference,
)
from equss_tpu_torch.ops.pq_assign import pq_assign, pq_assign_reference
from equss_tpu_torch.ops.quantizer import normalize_vectors

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _attention_input(B, N, H, hd, g, kind, n_real):
    """(B, N, 3, H, hd) bf16 of the input kind ``kind``
    (``attention_test_input``)."""
    return attention_test_input(torch.randn((B, N, 3, H, hd), generator=g, device=g.device),
                                kind, n_real)


def _check_1ulp(out, ref, items):
    """The first ``items`` batch items finite and within one bf16 ulp of
    the output's scale."""
    out, ref = out[:items].float(), ref[:items].float()
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().max())).item() - 7)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= ulp


@pytest.mark.parametrize("B,N,H,n_real,kind", [
    (2, 785, 6, 785, "randn"), (1, 70, 2, 33, "randn"), (3, 130, 12, 129, "randn"),
    (2, 896, 6, 785, "randn"),            # padded stream, ragged last real tile
    (2, 785, 6, 785, "late_max"), (2, 896, 6, 785, "late_max"),
    (2, 785, 6, 785, "late_max_near"),
    (2, 785, 6, 785, "nan_neighbour"),    # rows past N never read from item 1
])
def test_attention_kernel_matches_plain(cuda, B, N, H, n_real, kind):
    g = torch.Generator(device=cuda).manual_seed(B * N)
    qkv = _attention_input(B, N, H, 64, g, kind, n_real).reshape(B, N, 3 * 64 * H)
    before = attention_qkv.launches
    out = attention_qkv(qkv, H, 0.125, n_real)
    assert attention_qkv.launches == before + 1
    ref = attention_qkv_reference(qkv, H, 0.125, n_real)
    _check_1ulp(out, ref, 1 if kind == "nan_neighbour" else B)


@pytest.mark.parametrize("mode", ["none", "l2", "z_norm"])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("d,K", [(d, K) for d in (8, 16, 32) for K in (100, 128, 256, 300, 512)])
def test_pq_kernel_matches_plain(cuda, mode, exact, d, K):
    """n = 1000 leaves a ragged last row tile; K > 256 takes the fast
    mode's (value, index) minimum, K <= 256 its packed one.  K = 100 and
    300 leave a ragged last chunk of codewords and run with M = 5
    subspaces, so that the last group of subspaces is a partial one."""
    M = 8 if K % 128 == 0 else 5
    g = torch.Generator(device=cuda).manual_seed(3)
    z = 3.0 * torch.randn((1000, M, d), generator=g, device=cuda)
    cb = torch.randn((M, K, d), generator=g, device=cuda)
    cn = normalize_vectors(cb, mode).contiguous()
    before = pq_assign.launches
    idx, zn, zq = pq_assign(z, cn, cb, normalize=mode, exact=exact)
    assert pq_assign.launches == before + 1
    idx_r, zn_r, zq_r = pq_assign_reference(z, cn, cb, normalize=mode, exact=exact)
    agree = (idx == idx_r).float().mean().item()
    assert agree >= (0.9999 if exact else 0.995)
    assert bool(((idx >= 0) & (idx < K)).all())
    torch.testing.assert_close(zn, zn_r, rtol=1e-6, atol=1e-6)
    same = idx == idx_r
    assert torch.equal(zq[same], zq_r[same])
    src = cb if exact else cb.to(torch.bfloat16).float()
    assert torch.equal(zq, src[torch.arange(M, device=cuda), idx.long()])


WIDE_SHAPES = [  # M, K, d: each config's quantizer outside the pqgo family, then
    (1, 256, 1024),     # vq (vq_cocostuff27)
    (8, 2048, 64),      # new_vq, spq
    (4, 1024, 128),     # contra
    (16, 1024, 32),     # contra: (8d + 4) K bytes past shared memory
    (1, 2048, 384),     # unseg
    (1, 1024, 256),     # vae
    (2, 2800, 16),      # past the fast narrow body's shared memory
    (3, 100, 24),       # a ragged codeword tile and d not a multiple of 32
]


# the fast wide body's tiling (32-row blocks, 128-codeword tiles, 64-deep
# chunks, the row tile streamed past d = 2816): M, K, d, n, duplicated
# codewords (the second half of the codebook equal to the first)
WIDE_TILING = [
    pytest.param(1, 256, 1024, 5, False, id="n5-1-256-1024"),     # n below one row tile
    pytest.param(3, 100, 40, 1000, False, id="3-100-40"),         # d % 16 == 8
    pytest.param(1, 256, 1032, 1000, False, id="1-256-1032"),     # d % 16 == 8, d_pad 1088
    pytest.param(2, 1, 64, 1000, False, id="2-1-64"),             # K = 1
    pytest.param(2, 100, 128, 1000, False, id="2-100-128"),       # K = 100, one ragged tile
    pytest.param(2, 2048, 64, 1000, True, id="dup-2-2048-64"),    # equal distances
    pytest.param(1, 256, 2824, 1000, False, id="streamed-1-256-2824"),
    pytest.param(1, 300, 4104, 77, False, id="streamed-1-300-4104"),
    # past the exact body's fused threshold: it normalises in each mode itself
    pytest.param(1, 300, 264, 100315, False, id="fused-1-300-264"),
]


@pytest.mark.parametrize("mode", ["none", "l2", "z_norm", "z_trainable"])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("M,K,d,n,dup", [pytest.param(M, K, d, 1000, False, id=f"{M}-{K}-{d}")
                                         for M, K, d in WIDE_SHAPES] + WIDE_TILING)
def test_pq_wide_body_matches_plain(cuda, mode, exact, M, K, d, n, dup):
    """The wide body against the plain version; n = 1000 leaves a ragged
    last tile of 104 rows (8 in fast mode).  The bars of the narrow bodies;
    with duplicated codewords every index lies in the first half (equal
    distances: the lower index)."""
    from equss_tpu_torch.ops.pq_assign import kernel_body

    if not (M == 16 and d == 32 and not exact):
        assert kernel_body(d, K, exact) == "wide"
    g = torch.Generator(device=cuda).manual_seed(K + d)
    z = 3.0 * torch.randn((n, M, d), generator=g, device=cuda)
    cb = torch.randn((M, K, d), generator=g, device=cuda)
    if dup:
        cb[:, K // 2:] = cb[:, :K // 2]
    cn = normalize_vectors(cb, "l2" if mode == "z_trainable" else mode).contiguous()
    zm = zs = None
    if mode == "z_trainable":
        zm = 0.1 * torch.randn((M, d), generator=g, device=cuda)
        zs = torch.exp(0.1 * torch.randn((M, d), generator=g, device=cuda))
    kw = dict(normalize=mode, z_mean=zm, z_std=zs, exact=exact)
    before = pq_assign.launches
    idx, zn, zq = pq_assign(z, cn, cb, **kw)
    assert pq_assign.launches == before + 1
    idx_r, zn_r, zq_r = pq_assign_reference(z, cn, cb, **kw)
    agree = (idx == idx_r).float().mean().item()
    assert agree >= (0.9999 if exact else 0.995)
    assert bool(((idx >= 0) & (idx < (K // 2 if dup else K))).all())
    torch.testing.assert_close(zn, zn_r, rtol=1e-6, atol=1e-6)
    src = cb if exact else cb.to(torch.bfloat16).float()
    assert torch.equal(zq, src[torch.arange(M, device=cuda), idx.long()])


# the exact wide body's tiling (128-row blocks, 128-codeword tiles, 16-deep
# stages, each block a range of tiles, the ranges of a row tile on other
# blocks; fused where the row tiles fill the card): M, K, d, n
WIDE_EXACT_TILING = [
    pytest.param(1, 256, 1024, 5, id="n5-1-256-1024"),        # n below one row tile
    pytest.param(1, 256, 1024, 1000, id="1-256-1024"),        # a ragged last row tile
    pytest.param(2, 1, 64, 1000, id="K1-2-1-64"),
    pytest.param(3, 300, 128, 1000, id="3-300-128"),          # a ragged last codeword tile
    pytest.param(2, 100, 40, 1000, id="d40-2-100-40"),        # d % 16 == 8
    pytest.param(8, 2048, 64, 12800, id="ranges-8-2048-64"),  # several tiles per block
    pytest.param(1, 300, 264, 100315, id="fused-1-300-264"),  # fused, ragged rows and tiles
]


@pytest.mark.parametrize("case", ["random", "dup", "self"])
@pytest.mark.parametrize("M,K,d,n", WIDE_EXACT_TILING)
def test_pq_wide_exact_tiling_edges(cuda, M, K, d, n, case):
    """The exact wide body at its tiles' edges against the plain version
    (the bars of ``test_pq_wide_body_matches_plain``).  ``dup``: the
    codebook is four copies of its first quarter, so every minimum is a tie
    between tiles of one block's range and between blocks, and the lower
    index must win; ``self``: under l2, each row is a scaled codeword, so
    its distance to that codeword is near zero or just below, and the
    index is that codeword's.  At n = 100 315 the body runs fused (one
    block per row tile normalises and gathers); at n <= 12 800 split."""
    from equss_tpu_torch.ops.pq_assign import kernel_body, wide_config

    assert kernel_body(d, K, True) == "wide"
    launch = wide_config(n, M, K, d, "none", True)
    tiles = -(-K // 128)
    assert launch["fused"] == (n > 50000)
    if not launch["fused"] and n >= 1000 and K >= 256:
        assert launch["codeword_splits"] >= 2   # the ranges of a row tile on other blocks
    if M == 8:                      # and a block's range holds several tiles
        assert -(-tiles // launch["codeword_splits"]) >= 2
    g = torch.Generator(device=cuda).manual_seed(K + d + n)
    cb = torch.randn((M, K, d), generator=g, device=cuda)
    base = K // 4 if case == "dup" and K >= 4 else K
    cb = cb[:, :base].repeat(1, K // base, 1)
    mode = "l2" if case == "self" else "none"
    if case == "self":
        own = torch.arange(n, device=cuda) % K
        z = 3.0 * cb[:, own].transpose(0, 1).contiguous()
    else:
        z = 3.0 * torch.randn((n, M, d), generator=g, device=cuda)
    cn = normalize_vectors(cb, mode).contiguous()
    idx, zn, zq = pq_assign(z, cn, cb, normalize=mode, exact=True)
    idx_r, zn_r, _ = pq_assign_reference(z, cn, cb, normalize=mode, exact=True)
    assert (idx == idx_r).float().mean().item() >= 0.9999
    assert bool(((idx >= 0) & (idx < base)).all())
    torch.testing.assert_close(zn, zn_r, rtol=1e-6, atol=1e-6)
    assert torch.equal(zq, cb[torch.arange(M, device=cuda), idx.long()])
    if case == "self":
        assert torch.equal(idx, own[:, None].expand(n, M).to(torch.int32))


# the narrow exact body's tiling (R rows per thread: 4 at d = 16, 8 at
# d = 8, 3 at d = 32; a block per subspace and 256 R rows at d = 16,
# 128 R at d = 8 and 32; the codebook scanned in order): d, K, M, n
NARROW_EXACT_TILING = [
    pytest.param(16, 256, 4, 1000, id="ragged-16-256"),        # a ragged last block
    pytest.param(16, 256, 4, 3, id="n3-16-256"),               # n below one thread's rows
    pytest.param(8, 100, 5, 2049, id="d8-100"),                # R = 8, K and n ragged
    pytest.param(32, 77, 3, 515, id="d32-77"),                 # R = 3, K and n ragged
    pytest.param(16, 1, 2, 300, id="K1-16"),
    pytest.param(16, 1760, 4, 1000, id="top-16-1760"),         # the top of the narrow domain
    pytest.param(8, 3418, 2, 600, id="top-8-3418"),
    pytest.param(32, 894, 2, 600, id="top-32-894"),
    pytest.param(16, 256, 64, 70001, id="grid-64-256-16"),     # 69 row ranges of 64 blocks
]


@pytest.mark.parametrize("case", ["random", "dup", "zeros_nan"])
@pytest.mark.parametrize("d,K,M,n", NARROW_EXACT_TILING)
def test_pq_narrow_exact_tiling_edges(cuda, d, K, M, n, case):
    """The narrow exact body at its tiles' edges against the plain version
    (the bars of ``test_pq_kernel_matches_plain``, z_norm NaN where the
    input is).  ``dup``: codeword k is codeword k mod K / 4, so every
    minimum is an exact tie and the lower index must win; ``zeros_nan``
    (no normalisation): rows r % 7 == 0 are +0 and r % 7 == 3 are -0, so
    their distances are the codewords' c_sq and the index is the first
    least c_sq, with -0 kept in z_norm; rows r % 7 == 5 are NaN, no
    distance is below +inf and the index is 0."""
    from equss_tpu_torch.ops.pq_assign import kernel_body

    assert kernel_body(d, K, True) == "narrow"
    g = torch.Generator(device=cuda).manual_seed(K + d + n)
    cb = torch.randn((M, K, d), generator=g, device=cuda)
    base = max(1, K // 4) if case == "dup" else K
    cb = cb[:, torch.arange(K, device=cuda) % base].contiguous()
    z = 3.0 * torch.randn((n, M, d), generator=g, device=cuda)
    r = torch.arange(n, device=cuda) % 7
    if case == "zeros_nan":
        z[r == 0] = 0.0
        z[r == 3] = -0.0
        z[r == 5] = float("nan")
    mode = "none" if case == "zeros_nan" else "l2"
    cn = normalize_vectors(cb, mode).contiguous()
    before = pq_assign.launches
    idx, zn, zq = pq_assign(z, cn, cb, normalize=mode, exact=True)
    assert pq_assign.launches == before + 1
    idx_r, zn_r, _ = pq_assign_reference(z, cn, cb, normalize=mode, exact=True)
    assert (idx == idx_r).float().mean().item() >= 0.9999
    assert bool(((idx >= 0) & (idx < base)).all())
    torch.testing.assert_close(zn, zn_r, rtol=1e-6, atol=1e-6, equal_nan=True)
    assert torch.equal(zq, cb[torch.arange(M, device=cuda), idx.long()])
    if case == "zeros_nan":
        first = (cb * cb).sum(-1).argmin(-1).to(torch.int32)       # (M,)
        zero = (r == 0) | (r == 3)
        assert torch.equal(idx[zero], first.expand(int(zero.sum()), M))
        assert bool(torch.signbit(zn[r == 3]).all())
        assert bool((idx[r == 5] == 0).all())


def test_pq_forward_on_cuda_never_takes_the_plain_route(cuda):
    """Every config's (d, K) inside the JAX predicate runs the kernel on
    CUDA, in inference, under ``use_pallas: auto``."""
    for M, K, d in WIDE_SHAPES[:6] + [(64, 256, 16)]:
        for precision in ("exact", "bf16"):
            cfg = tq.PQConfig(num_pq=M, num_codebook=K, embed_dim=M * d, normalize="none",
                              assign_precision=precision)
            params, state = tq.pq_init(torch.Generator().manual_seed(0), cfg)
            params = {k: v.to(cuda) for k, v in params.items()}
            state = {k: v.to(cuda) for k, v in state.items()}
            before = pq_assign.launches
            tq.pq_forward(torch.randn((2, 5, 5, M * d), device=cuda), params, state, cfg)
            assert pq_assign.launches == before + 1, (M, K, d, precision)


def test_kernels_reject_what_they_do_not_take(cuda):
    qkv = torch.zeros((1, 8, 3 * 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attention_qkv(qkv, 1, 0.125)                   # head_dim 32
    with pytest.raises(TypeError):
        attention_qkv(qkv.float().reshape(1, 8, 96), 1, 0.125)
    z = torch.zeros((4, 2, 12), device=cuda)
    with pytest.raises(ValueError):
        pq_assign(z, torch.zeros((2, 128, 12), device=cuda),
                  torch.zeros((2, 128, 12), device=cuda))   # d = 12
    z = torch.zeros((4, 2, 20), device=cuda)
    cb = torch.zeros((2, 2800, 20), device=cuda)            # d % 8 != 0
    with pytest.raises(ValueError):
        pq_assign(z, cb, cb, exact=False)


@pytest.mark.parametrize("rows,C", [(25120, 384), (1000, 768), (37, 32), (5, 200)])
def test_layernorm_kernels_match_plain(cuda, rows, C):
    """At most 0.1% of elements differ, each by one bf16 ulp of
    max(|out|, |bias|); the add kernel's bf16 sum bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = (3 * torch.randn((rows, C), generator=g, device=cuda) + 1).to(torch.bfloat16)
    y = torch.randn((rows, C), generator=g, device=cuda).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(C, generator=g, device=cuda)
    bias = 0.1 * torch.randn(C, generator=g, device=cuda)
    before = fused_layernorm.launches, fused_add_layernorm.launches
    out = fused_layernorm(x, scale, bias)
    s, out2 = fused_add_layernorm(x, y, scale, bias)
    assert (fused_layernorm.launches, fused_add_layernorm.launches) == \
        (before[0] + 1, before[1] + 1)
    s_ref, ref2 = add_layernorm_reference(x, y, scale, bias)
    assert torch.equal(s, s_ref)
    for o, r in ((out, layernorm_reference(x, scale, bias)), (out2, ref2)):
        diff = (o.float() - r.float()).abs()
        mag = torch.maximum(r.float().abs(), bias.abs().expand_as(diff))
        ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
        assert (diff <= ulp).all()
        assert (diff > 0).float().mean().item() <= 1e-3


@pytest.mark.parametrize("B,N,H,hd,kind", [
    (2, 785, 6, 64, "randn"), (1, 1601, 2, 64, "randn"), (1, 5, 2, 64, "randn"),
    (2, 128, 1, 32, "randn"), (2, 785, 6, 64, "late_max"), (2, 785, 2, 32, "late_max"),
    (2, 785, 6, 64, "late_max_near"),
    (2, 785, 6, 64, "nan_neighbour"),
])
def test_fused_attention_kernel_matches_plain(cuda, B, N, H, hd, kind):
    g = torch.Generator(device=cuda).manual_seed(N)
    q, k, v = (t.contiguous() for t in _attention_input(B, N, H, hd, g, kind, N).unbind(2))
    before = fused_attention.launches
    out = fused_attention(q, k, v, scale=hd ** -0.5)
    assert fused_attention.launches == before + 1
    ref = fused_attention_reference(q, k, v, scale=hd ** -0.5)
    _check_1ulp(out, ref, 1 if kind == "nan_neighbour" else B)


def test_new_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fused_attention(q, q, q, scale=0.1)                   # head_dim 48
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fused_attention(q, q, q, scale=0.0)                   # scale not > 0
    unaligned = torch.zeros(8 * 2 * 64 + 1, device=cuda, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError):                           # base not 16-byte aligned
        fused_attention(unaligned.view(1, 8, 2, 64), q, q, scale=0.1)
    x = torch.zeros((4, 12), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fused_layernorm(x, torch.ones(12, device=cuda), torch.zeros(12, device=cuda))
    with pytest.raises(TypeError):
        fused_layernorm(x.float(), torch.ones(12, device=cuda), torch.zeros(12, device=cuda))


def test_ste_route_backward_matches_cpu(cuda):
    """One loss.backward() through the PQ kernel's training route on the
    card against the same on the CPU (plain version): the assignments
    agree on >= 99.5% of rows (fast mode, as the kernel tests), and the
    gradients of z and the codebook, taken where every assignment agrees,
    within 1e-5 of their largest magnitude."""
    cfg = tq.PQConfig(num_pq=8, num_codebook=256, embed_dim=128, normalize="l2",
                      use_pallas=True, assign_precision="bf16")
    g = torch.Generator().manual_seed(5)
    z0 = torch.randn((4, 30, 30, 128), generator=g)
    cb0 = torch.randn((8, 256, 16), generator=g)
    w = torch.randn((4, 30, 30, 128), generator=g)
    runs = {}
    for dev in ("cpu", cuda):
        z = z0.to(dev).detach().requires_grad_()            # a leaf on each side
        params = {"codebook": cb0.to(dev).detach().requires_grad_()}
        state = {"vq_count": torch.zeros((8, 256), device=dev)}
        before = pq_assign.launches
        zq, idx, aux, _ = tq.pq_forward(z, params, state, cfg, training=True)
        (aux["vq-loss"] + (zq * w.to(dev)).sum()).backward()
        assert pq_assign.launches == before + (0 if dev == "cpu" else 1)
        runs[str(dev)] = (idx.cpu(), z.grad.cpu(), params["codebook"].grad.cpu())
    (idx_c, gz_c, gc_c), (idx_g, gz_g, gc_g) = runs["cpu"], runs[str(cuda)]
    same = idx_c == idx_g
    assert same.float().mean().item() >= 0.995
    rows = same.reshape(-1, 8)
    torch.testing.assert_close(gz_g.reshape(-1, 8, 16)[rows], gz_c.reshape(-1, 8, 16)[rows],
                               rtol=0, atol=1e-5 * gz_c.abs().max().item())
    touched = torch.zeros((8, 256), dtype=torch.bool)
    for n, m in (~rows).nonzero().tolist():
        touched[m, idx_c.reshape(-1, 8)[n, m]] = True
        touched[m, idx_g.reshape(-1, 8)[n, m]] = True
    torch.testing.assert_close(gc_g[~touched], gc_c[~touched], rtol=0,
                               atol=1e-5 * gc_c.abs().max().item())


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: an operand on cuda:1 while cuda:0 is current")
    return torch.device("cuda:0"), torch.device("cuda:1")


def test_kernels_launch_on_the_operands_device(two_cards):
    """Each of the five wrappers on tensors of cuda:1 while cuda:0 is the
    current device: the launch and the library's per-device setup take
    the operand's device, and the output matches the plain version."""
    current, other = two_cards
    g = torch.Generator(device=other).manual_seed(6)
    with torch.cuda.device(current):
        qkv = _attention_input(2, 130, 2, 64, g, "randn", 130).reshape(2, 130, 3 * 128)
        out = attention_qkv(qkv, 2, 0.125)
        assert out.device == other
        _check_1ulp(out, attention_qkv_reference(qkv, 2, 0.125), 2)

        q, k, v = (t.contiguous() for t in _attention_input(2, 130, 2, 64, g, "randn",
                                                             130).unbind(2))
        out = fused_attention(q, k, v, scale=0.125)
        _check_1ulp(out, fused_attention_reference(q, k, v, scale=0.125), 2)

        x = torch.randn((300, 384), generator=g, device=other).to(torch.bfloat16)
        y = torch.randn((300, 384), generator=g, device=other).to(torch.bfloat16)
        scale = torch.ones(384, device=other)
        bias = torch.zeros(384, device=other)
        for o, r in ((fused_layernorm(x, scale, bias), layernorm_reference(x, scale, bias)),
                     (fused_add_layernorm(x, y, scale, bias)[1],
                      add_layernorm_reference(x, y, scale, bias)[1])):
            assert o.device == other
            diff = (o.float() - r.float()).abs()
            ulp = torch.exp2(torch.floor(torch.log2(r.float().abs().clamp_min(1e-30))) - 7)
            assert (diff <= ulp).all() and (diff > 0).float().mean().item() <= 1e-3

        z = torch.randn((1000, 8, 16), generator=g, device=other)
        cb = torch.randn((8, 256, 16), generator=g, device=other)
        cn = normalize_vectors(cb, "l2").contiguous()
        for exact in (True, False):
            idx, _, zq = pq_assign(z, cn, cb, normalize="l2", exact=exact)
            idx_r, _, _ = pq_assign_reference(z, cn, cb, normalize="l2", exact=exact)
            assert idx.device == other
            assert (idx == idx_r).float().mean().item() >= (0.9999 if exact else 0.995)
        torch.cuda.synchronize(other)
        assert torch.cuda.current_device() == current.index


def test_confusion_update_on_cuda_equals_cpu(cuda):
    from equss_tpu_torch.eval.metrics import confusion_update

    g = torch.Generator().manual_seed(7)
    preds = torch.randint(-1, 31, (8, 320, 320), generator=g, dtype=torch.int32)
    label = torch.randint(-1, 28, (8, 320, 320), generator=g, dtype=torch.int32)
    for extra in (0, 3):
        want = confusion_update(preds, label, 27, extra)
        got = confusion_update(preds.to(cuda), label.to(cuda), 27, extra)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)


def _op_cases(device):
    """(name, op, args, plain version) of each custom op on card operands
    the kernels take."""
    from equss_tpu_torch.ops.pq_assign import pq_assign_reference, pq_assign_shard_reference

    g = torch.Generator(device=device).manual_seed(11)
    qkv = _attention_input(2, 785, 6, 64, g, "randn", 785).reshape(2, 785, 3 * 384)
    q, k, v = (t.contiguous() for t in _attention_input(2, 130, 2, 64, g, "randn",
                                                         130).unbind(2))
    x = torch.randn((1000, 384), generator=g, device=device).to(torch.bfloat16)
    y = torch.randn((1000, 384), generator=g, device=device).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(384, generator=g, device=device)
    bias = 0.1 * torch.randn(384, generator=g, device=device)
    z = torch.randn((1000, 8, 16), generator=g, device=device)
    cb = torch.randn((8, 256, 16), generator=g, device=device)
    cn = normalize_vectors(cb, "l2").contiguous()
    ops = torch.ops.equss
    return [
        ("attention_qkv", ops.attention_qkv.default, (qkv, 6, 0.125, 785),
         lambda: attention_qkv_reference(qkv, 6, 0.125, 785)),
        ("attention", ops.attention.default, (q, k, v, 0.125),
         lambda: fused_attention_reference(q, k, v, scale=0.125)),
        ("layernorm", ops.layernorm.default, (x, scale, bias, 1e-6),
         lambda: layernorm_reference(x, scale, bias)),
        ("add_layernorm", ops.add_layernorm.default, (x, y, scale, bias, 1e-6),
         lambda: add_layernorm_reference(x, y, scale, bias)),
        ("pq_assign", ops.pq_assign.default, (z, cn, cb, None, None, "l2", True),
         lambda: pq_assign_reference(z, cn, cb, normalize="l2", exact=True)),
        ("pq_assign_shard", ops.pq_assign_shard.default,
         (z, cn[:, 128:].contiguous(), cb[:, 128:].contiguous(), None, None, "l2", True, 128, 256),
         lambda: pq_assign_shard_reference(z, cn[:, 128:], cb[:, 128:], 128, 256, normalize="l2",
                                           exact=True)),
    ]


def test_custom_ops_on_cuda_launch_the_kernels(cuda):
    """Each ``equss::`` op on CUDA tensors runs its kernel (one launch
    counted per call), agrees with its plain version at the kernel phases'
    bars, and passes ``torch.library.opcheck`` (its fake implementation
    against the kernel's outputs)."""
    from equss_tpu_torch.ops import KERNEL_WRAPPERS

    for name, op, args, plain in _op_cases(cuda):
        before = KERNEL_WRAPPERS[name].launches
        out, ref = op(*args), plain()
        assert KERNEL_WRAPPERS[name].launches == before + 1, name
        if name in ("attention_qkv", "attention"):
            _check_1ulp(out, ref, 2)
        elif name in ("pq_assign", "pq_assign_shard"):
            assert (out[0] == ref[0]).float().mean().item() >= 0.9999
        else:
            o = out if name == "layernorm" else out[1]
            r = ref if name == "layernorm" else ref[1]
            if name == "add_layernorm":
                assert torch.equal(out[0], ref[0])
            diff = (o.float() - r.float()).abs()
            mag = torch.maximum(r.float().abs(), args[-2].abs().expand_as(diff))
            ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
            assert (diff <= ulp).all() and (diff > 0).float().mean().item() <= 1e-3, name
        torch.library.opcheck(op, args)


def test_export_round_trip_on_cuda(cuda, tmp_path):
    """ViT-S/8 (2 blocks kept) in bf16 at 184^2 (530 tokens, over the
    attention kernel's 512) with ``use_pallas``, exported on the card:
    the artifact calls ``equss::attention_qkv`` and ``equss::pq_assign``,
    launches 2 + 1 kernels per request and predicts as the live model."""
    from equss_tpu_torch import launch_counts, reset_launch_counts, serve
    from equss_tpu_torch.models.equss import EQUSS, EQUSSConfig
    from equss_tpu_torch.train.trainer import Trainer

    cfg = {"seed": 0, "num_classes": 5,
           "model": {"name": "pqgo",
                     "pretrained": {"model_type": "vit_small", "dino_patch_size": 8,
                                    "dropout": False, "precision": "bf16"},
                     "vq": {"vq_type": "param", "num_codebooks": [128], "embed_dims": [64],
                            "normalize": "l2", "num_pq": [4], "need_initialized": "uni",
                            "assign_precision": "bf16", "use_pallas": True}},
           "loss": {"stego_weight": 1.0, "vq_weight": 1.0, "stego": {}},
           "optimizer": {k: {"name": "adam", "lr": 1e-3} for k in ("model", "cluster", "linear")},
           "eval": {"output_type": "vq0"}, "train": {}}
    model = EQUSS(EQUSSConfig.from_config(cfg), device=cuda, seed=0)
    del model.backbone.blocks[2:]
    tr = Trainer(cfg, device=cuda, model=model)
    exported = serve.export_predictor(tr, (184, 184), batch_size=2)
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets.count("equss.attention_qkv.default") == 2
    assert targets.count("equss.pq_assign.default") == 1
    predict = serve.load_predictor(serve.save_predictor(exported, str(tmp_path / "m.pt2")))
    live = serve.build_predict_fn(tr)
    for b in (1, 3):
        img = torch.rand((b, 184, 184, 3), generator=torch.Generator().manual_seed(b))
        reset_launch_counts()
        out = predict(img)
        counts = launch_counts()
        assert counts["attention_qkv"] == 2 and counts["pq_assign"] == 1, counts
        ref = live(img.to(cuda))
        for k in ref:
            assert out[k].device.type == "cuda" and torch.equal(out[k], ref[k]), k


@pytest.mark.parametrize("shape,exact", [
    ((4096, 64, 256, 16), False), ((4096, 64, 256, 16), True), ((4096, 64, 512, 16), False),
    ((1000, 1, 256, 1024), False), ((1000, 8, 2048, 64), False), ((1000, 1, 2048, 384), True),
    ((3000, 4, 1024, 128), True), ((1000, 4, 300, 16), False)])
@pytest.mark.parametrize("shards", [2, 4])
def test_pq_shard_launches_merge_to_the_whole_launch(cuda, shape, exact, shards):
    """``pq_assign_shard`` on K shards, merged by the least ``merge_key``
    (z_q from the owner), gives the indices and z_q of one ``pq_assign``
    launch over the whole codebook bit for bit: the narrow and wide bodies
    in both modes, the packed minimum of K <= 256 on shards of a larger
    codebook's K (512: the full form on every shard) and a K that splits
    unevenly into chunks (300 / 4 = 75)."""
    from equss_tpu_torch.ops.pq_assign import merge_key, packed_keys, pq_assign_shard

    n, M, K, d = shape
    g = torch.Generator(device=cuda).manual_seed(K + d)
    z = 3.0 * torch.randn((n, M, d), generator=g, device=cuda)
    cb = torch.randn((M, K, d), generator=g, device=cuda)
    cn = normalize_vectors(cb, "l2").contiguous()
    idx, zn, zq = pq_assign(z, cn, cb, normalize="l2", exact=exact)
    kp = K // shards
    outs = [pq_assign_shard(z, cn[:, r * kp:(r + 1) * kp].contiguous(),
                            cb[:, r * kp:(r + 1) * kp].contiguous(), r * kp, K,
                            normalize="l2", exact=exact) for r in range(shards)]
    win = torch.stack([merge_key(o[3], o[0], packed_keys(K, exact)) for o in outs]).amin(0)
    got = (win & 0xFFFFFFFF).to(torch.int32)
    assert torch.equal(got, idx)
    owner = (torch.stack([o[0] for o in outs]) == got).int().argmax(0)
    merged = torch.stack([o[2] for o in outs]).gather(
        0, owner[None, ..., None].expand(1, *zq.shape))[0]
    assert torch.equal(merged, zq)
    assert all(torch.equal(o[1], zn) for o in outs)
