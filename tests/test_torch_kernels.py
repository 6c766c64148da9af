"""Port kernels vs the reference: the plain PyTorch version behind each
wrapper (what a CPU tensor runs) against the JAX wrapper with its Pallas
kernel in interpret mode, on the same numpy inputs; the quantizer bit
for bit.  The CUDA kernels themselves are held against the plain
versions on the card by ``test_torch_kernels_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import quantization as tq
from repro_torch.kernels import fused_gn_swish as tgn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import w8a8_matmul as tmm


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape,axis', [
    ((16, 40), (1,)),          # per row (activations)
    ((40, 24), (0,)),          # per output channel (weights)
    ((3, 5, 7), None),         # per tensor
])
def test_quantize_bit_identical(shape, axis):
    x = _np(shape, 0, scale=3.0)
    a = jq.quantize(jnp.asarray(x), axis=axis)
    b = tq.quantize(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(np.asarray(a.q), b.q.numpy())
    np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())


def test_quantize_rounds_half_to_even_and_clamps_scale():
    # scale = 127/127 = 1 exactly, so every x/scale below is a tie
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]], np.float32)
    b = tq.quantize(torch.from_numpy(x), axis=(1,))
    np.testing.assert_array_equal(b.q.numpy(), [[127, 0, 2, 2, 0, -2]])
    zero = tq.quantize(torch.zeros(2, 3), axis=(1,))
    np.testing.assert_array_equal(
        zero.scale.numpy(),
        np.full((2, 1), np.float32(1e-8) / np.float32(127)))
    assert int(zero.q.abs().max()) == 0


# ---------------------------------------------------------------------------
# W8A8 matmul: exact (integer accumulation, same epilogue order)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('M,K,N', [
    (8, 64, 32), (64, 200, 96), (1, 300, 7), (257, 129, 65), (77, 48, 40),
])
def test_w8a8_plain_matches_reference_exactly(M, K, N):
    x, w = _np((M, K), 1), _np((K, N), 2)
    want = np.asarray(jops.w8a8_matmul(jnp.asarray(x), jnp.asarray(w),
                                       mode='interpret'))
    got = tops.w8a8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)


def test_w8a8_prequantized_weight_and_leading_dims():
    x, w = _np((2, 3, 96), 3), _np((96, 48), 4)
    jw = jq.quantize_per_channel(jnp.asarray(w))
    want = np.asarray(jops.w8a8_matmul(jnp.asarray(x), jw, mode='interpret'))
    tw = tq.QTensor(torch.from_numpy(np.array(jw.q)),
                    torch.from_numpy(np.array(jw.scale)))
    got = tops.w8a8_matmul(torch.from_numpy(x), tw)
    assert got.shape == (2, 3, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)


def test_w8a8_plain_matches_reference_oracle_on_int_operands():
    rng = np.random.default_rng(5)
    xq = rng.integers(-127, 128, size=(33, 70), dtype=np.int8)
    wq = rng.integers(-127, 128, size=(70, 21), dtype=np.int8)
    xs = rng.uniform(0.01, 0.1, size=(33, 1)).astype(np.float32)
    ws = rng.uniform(0.01, 0.1, size=(1, 21)).astype(np.float32)
    want = np.asarray(jref.w8a8_matmul_ref(jnp.asarray(xq), jnp.asarray(xs),
                                           jnp.asarray(wq), jnp.asarray(ws)))
    got = tmm.w8a8_matmul_plain(*(torch.from_numpy(a)
                                  for a in (xq, xs, wq, ws)))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# W8A8: the CUDA kernel's operands (K-major, K padded) and its plan
# ---------------------------------------------------------------------------

# the products of the paths: SD v1.4 at batch 4 (chip_smoke.py phase 3),
# InternLM2-1.8B's projections at the prefill (M = 4000) and a decode step
# (M = 4), and the ragged on-card test shapes
W8A8_PATH_SHAPES = [(4096, 680, 680), (1024, 1360, 1360), (256, 1360, 1360),
                    (308, 768, 680), (308, 768, 1360)] + [
    (M, K, N) for M in (4000, 4)
    for K, N in ((2048, 2048), (2048, 8192), (8192, 2048))] + [
    (257, 129, 65), (1, 300, 7)]


@pytest.mark.parametrize('M,K,N', [(33, 129, 21), (5, 300, 7), (40, 680, 24)])
def test_w8a8_kmajor_padded_operands_match_reference(M, K, N):
    """The kernel's operands, K-major and zero-padded to a multiple of 16,
    give the reference oracle's result exactly through the plain version:
    the zero columns add nothing to the int32 sums."""
    rng = np.random.default_rng(M + K)
    xq = rng.integers(-127, 128, size=(M, K), dtype=np.int8)
    wq = rng.integers(-127, 128, size=(K, N), dtype=np.int8)
    xs = rng.uniform(0.01, 0.1, size=(M, 1)).astype(np.float32)
    ws = rng.uniform(0.01, 0.1, size=(1, N)).astype(np.float32)
    want = np.asarray(jref.w8a8_matmul_ref(jnp.asarray(xq), jnp.asarray(xs),
                                           jnp.asarray(wq), jnp.asarray(ws)))
    Kp = -(-K // 16) * 16
    xp = tmm.pad_k(torch.from_numpy(xq))
    wt = tmm.kmajor_weight(torch.from_numpy(wq))
    assert xp.shape == (M, Kp) and wt.shape == (N, Kp) and Kp > K
    assert xp.is_contiguous() and wt.is_contiguous()
    assert int(xp[:, K:].abs().sum()) == 0 and int(wt[:, K:].abs().sum()) == 0
    got = tmm.w8a8_matmul_plain(xp, torch.from_numpy(xs), wt.t(),
                                torch.from_numpy(ws))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('M,K,N', [(6, 129, 21), (4, 680, 40), (3, 64, 16)])
def test_w8a8_kmajor_quantizers_match_reference_quantize(M, K, N):
    """The CUDA path's quantizers write the reference's int8 values and
    scales, the weight's transposed, both K-padded."""
    x, w = _np((M, K), 9, scale=2.0), _np((K, N), 10)
    jx = jq.quantize(jnp.asarray(x), axis=(1,))
    jw = jq.quantize_per_channel(jnp.asarray(w))
    xp, xs = tmm.quantize_rows_padded(torch.from_numpy(x))
    wt, ws = tmm.quantize_weight_kmajor(torch.from_numpy(w))
    np.testing.assert_array_equal(xp[:, :K].numpy(), np.asarray(jx.q))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jx.scale))
    np.testing.assert_array_equal(wt[:, :K].numpy(), np.asarray(jw.q).T)
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jw.scale))
    assert xp.shape[1] == wt.shape[1] == -(-K // 16) * 16
    assert xp.is_contiguous() and wt.is_contiguous()


@pytest.mark.parametrize('M,K,N', W8A8_PATH_SHAPES)
def test_w8a8_plan_is_legal_at_path_shapes(M, K, N):
    """A wgmma N that is a multiple of 8 up to 256, covering M when the
    operands swap (M < 64); a split that divides the K boxes; and, at small
    M, enough blocks to stream the weight on every SM unless K has no
    more boxes to split."""
    plan = tmm.w8a8_plan(M, N, K)
    assert plan.bn % 8 == 0 and 8 <= plan.bn <= 256
    assert plan.k_boxes == -(-(-(-K // 16) * 16) // 128)
    assert plan.split >= 1 and plan.k_boxes % plan.split == 0
    assert plan.swap == (M < 64)
    rows_p, rows_q = (N, M) if plan.swap else (M, N)
    assert plan.blocks == (-(-rows_p // 128) * -(-rows_q // plan.bn)
                           * plan.split)
    if plan.swap:
        assert plan.bn >= M
        assert plan.blocks >= tmm.SMS or plan.split == plan.k_boxes
    else:
        assert plan.bn == 128 and plan.split == 1
    assert plan.device_launches == (3 if plan.split > 1 else 1)


def test_w8a8_dynamic_and_prequantized_paths_agree_on_cpu():
    """A Linear quantized once carries the reference's (K, N) QTensor on
    the CPU (no K-major copy there) and gives the dynamic path's result."""
    from repro_torch.models.layers import Linear
    lin = Linear(40, 24)
    lin.w.data = torch.from_numpy(_np((40, 24), 11))
    x = torch.from_numpy(_np((3, 40), 12))
    want = tops.w8a8_matmul(x, lin.w.data)
    lin.quantize_()
    qt = lin.weight
    assert qt.q.shape == (40, 24) and qt.kmajor is None
    assert torch.equal(tops.w8a8_matmul(x, qt), want)


# ---------------------------------------------------------------------------
# fused GroupNorm + swish; atol 1e-5 as the reference's own kernel test
# (float32 statistics summed in different orders)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('N,H,W,C,groups', [
    (2, 8, 8, 64, 8),
    (1, 16, 16, 32, 32),
    (3, 4, 4, 96, 6),
    (2, 8, 8, 340, 32),     # fallback to g = 20: cg = 17, not a power of 2
    (1, 4, 4, 1020, 32),    # fallback to g = 30: cg = 34
    (2, 4, 4, 100, 32),     # fallback to g = 25
])
def test_gn_swish_plain_matches_reference(N, H, W, C, groups):
    x = _np((N, H, W, C), 6, scale=2.0, shift=0.5)
    sc, bi = _np((C,), 7), _np((C,), 8)
    want = np.asarray(jops.fused_gn_swish(
        jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi), groups=groups,
        mode='interpret'))
    got = tops.fused_gn_swish(torch.from_numpy(x), torch.from_numpy(sc),
                              torch.from_numpy(bi), groups=groups)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# (H, W, C, groups) of every GroupNorm+swish call of SD v1.4 (chip_smoke.py
# phase 3 records them at batch 4)
GN_PATH_SHAPES = [(8, 8, 1360, 20), (8, 8, 2720, 32), (16, 16, 680, 20),
                  (16, 16, 1360, 20), (16, 16, 2040, 30), (16, 16, 2720, 32),
                  (32, 32, 340, 20), (32, 32, 680, 20), (32, 32, 1020, 30),
                  (32, 32, 1360, 20), (32, 32, 2040, 30), (64, 64, 340, 20),
                  (64, 64, 680, 20), (64, 64, 1020, 30)]


@pytest.mark.parametrize('H,W,C,g', GN_PATH_SHAPES)
def test_gn_cluster_plan_keeps_path_slabs_in_shared_memory(H, W, C, g):
    """Every path slab is held in the shared memory of at most 8 blocks,
    each within the 227 KB a block may use, with no block left without a
    position; a slab that fits one block's aim gets a cluster of one."""
    plan = tgn.gn_plan(H * W, C // g)
    assert 1 <= plan.cluster <= 8 and plan.resident
    assert plan.smem == plan.chunk * (C // g) * 4 <= 232448
    assert plan.cluster * plan.chunk >= H * W > (plan.cluster - 1) * plan.chunk
    if H * W * (C // g) * 4 <= tgn.CHUNK_BYTES:
        assert plan.cluster == 1


def test_gn_cluster_plan_streams_slabs_too_large_for_a_cluster():
    plan = tgn.gn_plan(128 * 128, 64)           # 4 MB: 512 KB a block
    assert plan.cluster == 8 and not plan.resident and plan.smem == 0
    assert plan.cluster * plan.chunk >= 128 * 128


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty((1, 2, 2, 4), device='meta')
    with pytest.raises(ValueError, match='no kernel'):
        tops.fused_gn_swish(x, torch.empty(4, device='meta'),
                            torch.empty(4, device='meta'), groups=2)
    with pytest.raises(ValueError, match='needs a CUDA tensor'):
        tgn.fused_gn_swish_kernel(torch.zeros(1, 2, 2, 4), torch.ones(4),
                                  torch.zeros(4), 2)
    with pytest.raises(ValueError, match='needs CUDA tensors'):
        tmm.w8a8_matmul_kernel(torch.zeros(2, 3, dtype=torch.int8),
                               torch.ones(2, 1),
                               torch.zeros(3, 4, dtype=torch.int8),
                               torch.ones(1, 4))


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    tops.reset_launches()
    tops.fused_gn_swish(torch.randn(1, 4, 4, 8), torch.ones(8),
                        torch.zeros(8), groups=4)
    tops.w8a8_matmul(torch.randn(3, 8), torch.randn(8, 5))
    q = torch.randn(1, 2, 5, 16)
    tops.flash_attention(q, q, q, causal=True)
    tops.conv2d(torch.randn(1, 4, 4, 8), torch.randn(5, 8, 3, 3), (1, 1),
                (1, 1))
    assert tops.launch_counts() == {'fused_gn_swish': 0, 'w8a8_matmul': 0,
                                    'flash_attention': 0, 'conv2d_nhwc': 0}
