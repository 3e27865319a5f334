"""Oobleck decoder kernels (CUDA) and their plain PyTorch versions.

Port of `acestep_tpu/ops/pallas_vae.py`. On the card each wrapper takes one
of two routes:

- the Hopper route, bf16 activations at the widths of `csrc/oobleck_sm90.cu`:
  a Snake launch (`csrc/oobleck.cu`), then implicit-GEMM convolutions (TMA +
  wgmma);
- the narrow route, every other width the JAX package sends to its Pallas
  kernels (C_out <= 512, chain C <= 1024) and fp32 activations at any width:
  `csrc/oobleck_generic.cu`, a Snake launch, then implicit-GEMM convolutions
  on the tensor cores (`mma.sync`; bf16 activations against fp32 weights
  split into bf16 hi and lo parts, fp32 in 3xTF32): the conv_t with the first
  unit's Snake1, then one launch per residual unit (z in shared memory),
  rounded to the activation dtype where the plain versions round.

- `decoder_block_kernel` replaces `decoder_block_pallas`: one Oobleck decoder
  block, Snake -> ConvTranspose1d (K = 2s, pad s/2) -> 3 residual units. On
  the Hopper route (C_out in SM90_CHANNELS, C_in a multiple of 128): the
  upsampling conv with the first unit's Snake in its epilogue, then one fused
  launch per residual unit at C <= 256 (z stays in registers) or two at
  C = 512 (z through HBM).
- `res_units_kernel` replaces `res_units_pallas`: the 3-residual-unit chain
  alone (decoder block 0, 1024 channels). On the Hopper route (C in
  CHAIN_CHANNELS, every multiple of 128 up to 1024): Snake, then per unit
  kernel 2's fused launch at C <= 256 (4 launches), else a k7 launch (z
  through HBM) and a k1 launch with the next unit's Snake in its epilogue (7
  launches). At multiples of 256 the k7s run on a stream-K schedule
  (`streamk_schedule`: the 72 or 172 tiles of a decode chunk leave SMs idle
  in whole-tile rounds); at 384, 640 and 896 both stages run whole tiles of
  128 channels.

The source notes give each design and what bounds it on an H100. Each wrapper
counts its calls that launch kernels in `.launches`, and those that took the
narrow route also in `.narrow_launches`. A CPU tensor takes the plain version
beside it, which rounds to the input dtype at the same points as the kernels;
a CUDA tensor launches the kernels or raises.

Rows outside [0, L) read as zeros (torch zero padding), so the halo gates of
the TPU kernels (`TOTAL_HALO`, `_upsample_halo`) only keep the dispatch in
`models/vae.decoder_block` identical to the JAX package's.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from acestep_tpu_torch.ops import cuda_lib
from acestep_tpu_torch.ops.basic import sin2_f32
from acestep_tpu_torch.ops.conv import conv_transpose1d

DILATIONS = (1, 3, 9)
TOTAL_HALO = 40  # the TPU kernels' halo: 39 rows (3 * (1 + 3 + 9)) rounded to 8

_P = ctypes.c_void_p
_SIGNATURES = {
    "acestep_snake": ([_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P], ctypes.c_int),
}
_SM90_SIGNATURES = {
    "acestep_oob_upsample": ([_P] * 7 + [ctypes.c_int] * 5 + [_P], ctypes.c_int),
    "acestep_oob_unit": ([_P] * 12 + [ctypes.c_int] * 4 + [_P], ctypes.c_int),
    "acestep_oob_k7": ([_P] * 6 + [ctypes.c_int] * 4 + [_P] * 4, ctypes.c_int),
    "acestep_oob_k1": ([_P] * 8 + [ctypes.c_int] * 3 + [_P] * 4, ctypes.c_int),
}
_GEN_SIGNATURES = {
    "acestep_gen_snake": ([_P] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P], ctypes.c_int),
    "acestep_gen_unit": ([_P] * 14 + [ctypes.c_int] * 8 + [_P], ctypes.c_int),
    "acestep_gen_upsample": ([_P] * 8 + [ctypes.c_int] * 9 + [_P], ctypes.c_int),
}
SM90_CHANNELS = (128, 256, 512)  # output channels the Hopper decoder-block kernels take
CHAIN_CHANNELS = tuple(range(128, 1025, 128))  # channels the Hopper residual-chain kernel takes
# The JAX package's gates for its Pallas kernels: the widths the two wrappers
# take on the card at all (the narrow route below the Hopper widths).
BLOCK_MAX_CHANNELS, CHAIN_MAX_CHANNELS = 512, 1024
NARROW_DTYPES = (torch.bfloat16, torch.float32)

# The k7 and k1 launches' tiles: 128 rows x 256 output channels of one batch
# row, K steps of 64 input channels per tap.
TILE_ROWS, TILE_COLS, STEP_CHANNELS = 128, 256, 64
# Fewest K steps a stream-K CTA takes: every split adds a 128 KB running sum
# written to L2 and read back by the CTA above it, so a launch of few tiles
# splits each over at most steps / 8 CTAs (14 at 1024 channels).
STREAMK_MIN_STEPS = 8
# A CTA's workspace slot: fp32 accumulators of one 128 x 256 tile.
SLOT_FLOATS = TILE_ROWS * TILE_COLS


def _upsample_halo(s: int) -> int:
    """Input halo rows per side of the TPU block kernel (kept for the gates)."""
    need = -(-TOTAL_HALO // s) + 1
    return -(-need // 8) * 8


def snake_consts(p: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(exp(alpha), 1 / (exp(beta) + 1e-9)) in fp32; alpha/beta are stored as logs."""
    return torch.exp(p["alpha"].float()), 1.0 / (torch.exp(p["beta"].float()) + 1e-9)


def snake_f32(xf: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    a, inv_b = snake_consts(p)
    return xf + inv_b * sin2_f32(a * xf)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _conv_f32(x: torch.Tensor, kernel: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """fp32 'same' conv in NLC with a (K, Ci, Co) kernel."""
    k = kernel.shape[0]
    pad = (k - 1) * dilation // 2
    y = F.conv1d(x.transpose(1, 2), kernel.float().permute(2, 1, 0), padding=pad, dilation=dilation)
    return y.transpose(1, 2)


def res_unit_plain(h: torch.Tensor, p: Dict[str, Any], dilation: int) -> torch.Tensor:
    dtype = h.dtype
    a = snake_f32(h.float(), p["snake1"]).to(dtype)
    acc = _conv_f32(a.float(), p["conv1"]["kernel"], dilation) + p["conv1"]["bias"].float()
    z = snake_f32(acc, p["snake2"]).to(dtype)
    out = h.float() + _conv_f32(z.float(), p["conv2"]["kernel"]) + p["conv2"]["bias"].float()
    return out.to(dtype)


def res_units_plain(x: torch.Tensor, unit_params: Sequence[Dict[str, Any]]) -> torch.Tensor:
    for p, d in zip(unit_params, DILATIONS):
        x = res_unit_plain(x, p, d)
    return x


def decoder_block_plain(x: torch.Tensor, p: Dict[str, Any], stride: int) -> torch.Tensor:
    dtype = x.dtype
    a = snake_f32(x.float(), p["snake1"]).to(dtype)
    ct = p["conv_t1"]
    bias = ct.get("bias")
    y = conv_transpose1d(
        a.float(), ct["kernel"].float(), None if bias is None else bias.float(),
        stride=stride, padding=stride // 2,
    ).to(dtype)
    return res_units_plain(y, (p["res_unit1"], p["res_unit2"], p["res_unit3"]))


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------


def _lib():
    return cuda_lib.load("oobleck", _SIGNATURES)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def conv_tiles(b: int, l: int, n: int) -> int:
    """Output tiles of a k7 / k1 launch over (b, l) rows and n output channels."""
    return -(-l // TILE_ROWS) * (n // TILE_COLS) * b


Schedule = Tuple[int, int, int, int, int]  # (grid, dp_tiles, sk_ctas, sk_q, sk_r)


def streamk_schedule(tiles: int, steps: int, sms: int) -> Schedule:
    """The chain's k7 walk over `tiles` output tiles of `steps` K steps each
    on at most `sms` persistent CTAs: whole data-parallel rounds first (tiles
    [0, dp_tiles), CTA c taking c, c + grid, ...), then the last, partial
    round's K steps split evenly over the first sk_ctas CTAs, CTA c taking
    sk_q steps plus one if c < sk_r, at least STREAMK_MIN_STEPS each.
    `csrc/oobleck_sm90.cu` (`sk_segments`) walks each CTA's run of steps
    from the top down, so a CTA waits only for the CTA below it."""
    sk_tiles = tiles % sms
    dp_tiles = tiles - sk_tiles
    sk_steps = sk_tiles * steps
    if not sk_steps:
        return min(tiles, sms), dp_tiles, 0, 0, 0
    sk_ctas = min(sms, max(1, sk_steps // STREAMK_MIN_STEPS))
    sk_q, sk_r = divmod(sk_steps, sk_ctas)
    return (sms if dp_tiles else sk_ctas), dp_tiles, sk_ctas, sk_q, sk_r


def _check_act(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.bfloat16 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{what}: expects a contiguous bf16 (B, L, C) tensor, got {x.dtype} {tuple(x.shape)}")
    if x.shape[-1] % 128:
        raise ValueError(f"{what}: channel count {x.shape[-1]} is not a multiple of 128")


def _snake_launch(x: torch.Tensor, ae: torch.Tensor, ib: torch.Tensor) -> torch.Tensor:
    y = torch.empty_like(x)
    rc = _lib().acestep_snake(
        x.data_ptr(), ae.data_ptr(), ib.data_ptr(), y.data_ptr(), x.numel(), x.shape[-1], _stream(x)
    )
    cuda_lib.check(rc, "oobleck snake")
    return y


def phase_weights(kernel: torch.Tensor, stride: int) -> torch.Tensor:
    """(2s, Ci, Co) transposed-conv kernel -> (3, Ci, s*Co) taps on x[t-1],
    x[t], x[t+1], with output phase r in columns [r*Co, (r+1)*Co)."""
    s, half = stride, stride // 2
    _, ci, co = kernel.shape
    w = torch.zeros((3, ci, s, co), dtype=kernel.dtype, device=kernel.device)
    w[0, :, :half] = kernel[3 * half :].permute(1, 0, 2)  # x[t-1] -> phases r < s/2
    w[1] = kernel[half : half + s].permute(1, 0, 2)  # x[t] -> every phase
    w[2, :, half:] = kernel[:half].permute(1, 0, 2)  # x[t+1] -> phases r >= s/2
    return w.reshape(3, ci, s * co)


def pack_conv_weights(kernel: torch.Tensor) -> torch.Tensor:
    """(K, C_in, N) conv kernel -> (K, N, C_in) bf16: each tap K-major, the
    B-operand layout of `csrc/oobleck_sm90.cu` (the wrappers keep one per
    weight tensor)."""
    return kernel.permute(0, 2, 1).to(torch.bfloat16).contiguous()


def _sm90():
    return cuda_lib.load("oobleck_sm90", _SM90_SIGNATURES)


# Kernel operands derived from weights (packed kernels, fp32 biases, Snake
# constants), kept per weight tensor so that a decode does not rebuild them
# on every call: an entry holds while its tensors live unchanged (same
# objects, same version counters) and is dropped when one is freed.
_DERIVED: Dict[tuple, Tuple[tuple, Any]] = {}


def _version(t: torch.Tensor) -> Optional[int]:
    try:
        return t._version
    except RuntimeError:  # inference tensors keep no version counter (nor change in place)
        return None


def _derived(tag: str, tensors: Tuple[torch.Tensor, ...], make: Callable[[], Any]) -> Any:
    key = (tag,) + tuple(id(t) for t in tensors)
    stamp = tuple(_version(t) for t in tensors)
    hit = _DERIVED.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], tensors)) and hit[1] == stamp:
        return hit[2]
    value = make()
    drop = lambda _ref, key=key: _DERIVED.pop(key, None)
    _DERIVED[key] = (tuple(weakref.ref(t, drop) for t in tensors), stamp, value)
    return value


def _f32(t: Optional[torch.Tensor], n: int, device: torch.device, repeat: int = 1) -> torch.Tensor:
    if t is None:
        return torch.zeros(n, device=device)
    return _derived(f"f32x{repeat}", (t,), lambda: t.float().repeat(repeat).contiguous())


def _packed(kernel: torch.Tensor, stride: Optional[int] = None) -> torch.Tensor:
    """pack_conv_weights of the kernel, or of its phase weights when `stride` is given."""
    if stride is None:
        return _derived("packed", (kernel,), lambda: pack_conv_weights(kernel))
    return _derived(f"phase{stride}", (kernel,), lambda: pack_conv_weights(phase_weights(kernel, stride)))


def _snake_consts(p: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    return _derived("snake", (p["alpha"], p["beta"]), lambda: snake_consts(p))


def decoder_block_takes(c_in: int, c_out: int) -> bool:
    """Whether `decoder_block_kernel` takes a block of these widths on the card."""
    return c_out in SM90_CHANNELS and c_in % 128 == 0


def _check_sm90(what: str, c: int, *ts: torch.Tensor, channels: Sequence[int] = SM90_CHANNELS) -> None:
    """What the TMA kernels take: CUDA bf16 (B, L, C) contiguous, 16-byte
    aligned bases (TMA reads nothing else), C in `channels`."""
    if c not in channels:
        raise ValueError(f"{what}: {c} channels; the kernels take {tuple(channels)}")
    for t in ts:
        if t.device.type != "cuda" or t.dtype != torch.bfloat16 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{what}: expects contiguous bf16 (B, L, C) CUDA tensors, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: base address not 16-byte aligned; TMA cannot read it")


def upsample_sm90(
    a0: torch.Tensor, ct: Dict[str, torch.Tensor], stride: int, snake_next: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ConvTranspose1d (K = 2s, pad s/2) of a0 = bf16(Snake(x)), (B, L, C_in)
    -> y (B, L s, C_out) = bf16(conv_t + bias) and a1 = bf16(snake_next(y)),
    in one launch (CUDA tensors only)."""
    b, l, ci = a0.shape
    co = ct["kernel"].shape[2]
    _check_sm90("upsample_sm90", co, a0)
    n = stride * co
    w = _packed(ct["kernel"], stride)
    bias = _f32(ct.get("bias"), n, a0.device, repeat=stride)
    ae, ib = _snake_consts(snake_next)
    y = torch.empty((b, l, n), dtype=torch.bfloat16, device=a0.device)
    a1 = torch.empty_like(y)
    rc = _sm90().acestep_oob_upsample(
        a0.data_ptr(), w.data_ptr(), bias.data_ptr(), ae.data_ptr(), ib.data_ptr(),
        y.data_ptr(), a1.data_ptr(), b, l, ci, n, co, _stream(a0),
    )
    cuda_lib.check(rc, "oobleck_sm90 upsample")
    return y.view(b, l * stride, co), a1.view(b, l * stride, co)


def res_unit_sm90(
    h: torch.Tensor,
    a: torch.Tensor,
    p: Dict[str, Any],
    dilation: int,
    snake_next: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One residual unit from h and a = bf16(Snake1(h)) (CUDA tensors only):
    h' = bf16(h + conv_k1(z) + b2) with z = bf16(Snake2(conv_k7,d(a) + b1)),
    and a_next = bf16(snake_next(h')) when `snake_next` is given. One launch
    at C <= 256 (z in registers), two at C = 512 (z through HBM)."""
    b, l, c = h.shape
    _check_sm90("res_unit_sm90", c, h, a)
    if a.shape != h.shape:
        raise ValueError(f"res_unit_sm90: a {tuple(a.shape)} and h {tuple(h.shape)} differ")
    if c > 256:
        return _k1(_k7(a, p, dilation, None), h, p, snake_next, None)
    w1, w2 = _packed(p["conv1"]["kernel"]), _packed(p["conv2"]["kernel"])
    b1 = _f32(p["conv1"].get("bias"), c, h.device)
    b2 = _f32(p["conv2"].get("bias"), c, h.device)
    ae1, ib1 = _snake_consts(p["snake2"])
    out = torch.empty_like(h)
    a_next = aen = ibn = None
    if snake_next is not None:
        a_next = torch.empty_like(h)
        aen, ibn = _snake_consts(snake_next)
    rc = _sm90().acestep_oob_unit(
        a.data_ptr(), h.data_ptr(), w1.data_ptr(), b1.data_ptr(), ae1.data_ptr(), ib1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), _ptr(aen), _ptr(ibn), out.data_ptr(), _ptr(a_next),
        b, l, c, dilation, _stream(h),
    )
    cuda_lib.check(rc, "oobleck_sm90 unit")
    return out, a_next


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


class _StreamK:
    """The stream-K state of one card and stream: a workspace slot and a flag
    per SM, and the launch epoch. Launches on one stream run in order, so
    they share the workspace, and launches on two streams use two; a flag
    holds the epoch of the launch that last filled its slot, so no launch
    resets the flags. A CUDA graph would replay a launch with its old epoch,
    which the flags may already hold: `res_units_kernel` refuses capture."""

    def __init__(self, device: torch.device):
        self.sms = torch.cuda.get_device_properties(device).multi_processor_count
        self.ws = torch.empty(self.sms * SLOT_FLOATS, dtype=torch.float32, device=device)
        self.flags = torch.zeros(self.sms, dtype=torch.int32, device=device)
        self.epoch = 0

    def next_epoch(self) -> int:
        if self.epoch == 2**31 - 1:  # the flags are int32: start again from 0
            self.flags.zero_()
            self.epoch = 0
        self.epoch += 1
        return self.epoch


_STREAMK: Dict[Tuple[int, int], _StreamK] = {}


def _streamk(x: torch.Tensor) -> _StreamK:
    key = (x.device.index, _stream(x))
    st = _STREAMK.get(key)
    if st is None:
        st = _STREAMK[key] = _StreamK(x.device)
    return st


def _sched(sched: Schedule, epoch: int) -> ctypes.Array:
    return (ctypes.c_int * 6)(*sched, epoch)


def _k7(a: torch.Tensor, p: Dict[str, Any], dilation: int, sk: Optional[_StreamK]) -> torch.Tensor:
    """A unit's k7 launch, C a multiple of 128: z = bf16(Snake2(conv_k7,d(a)
    + b1)) to HBM, on whole tiles (`sk` None: kernel 2's units at C = 512,
    kernel 3 at 384, 640, 896) or on the stream-K schedule of `sk`'s card
    (kernel 3 at multiples of 256)."""
    b, l, c = a.shape
    w1 = _packed(p["conv1"]["kernel"])
    b1 = _f32(p["conv1"].get("bias"), c, a.device)
    ae1, ib1 = _snake_consts(p["snake2"])
    z = torch.empty_like(a)
    sched = ws = flags = None
    if sk is not None:
        sched = _sched(streamk_schedule(conv_tiles(b, l, c), 7 * c // STEP_CHANNELS, sk.sms), sk.next_epoch())
        ws, flags = sk.ws.data_ptr(), sk.flags.data_ptr()
    rc = _sm90().acestep_oob_k7(
        a.data_ptr(), w1.data_ptr(), b1.data_ptr(), ae1.data_ptr(), ib1.data_ptr(), z.data_ptr(),
        b, l, c, dilation, sched, ws, flags, _stream(a),
    )
    cuda_lib.check(rc, "oobleck_sm90 k7")
    return z


def _k1(
    z: torch.Tensor,
    h: torch.Tensor,
    p: Dict[str, Any],
    snake_next: Optional[Dict[str, torch.Tensor]],
    sk: Optional[_StreamK],
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A unit's k1 launch on whole tiles: h' = bf16(h + conv_k1(z) + b2) and
    a_next = bf16(snake_next(h')) when `snake_next` is given; on kernel 3's
    instance when `sk` is given, so that a profile tells the kernels apart."""
    b, l, c = h.shape
    w2 = _packed(p["conv2"]["kernel"])
    b2 = _f32(p["conv2"].get("bias"), c, h.device)
    out = torch.empty_like(h)
    a_next = aen = ibn = None
    if snake_next is not None:
        a_next = torch.empty_like(h)
        aen, ibn = _snake_consts(snake_next)
    sched = None
    if sk is not None:
        tiles = conv_tiles(b, l, c)
        sched = _sched((min(tiles, sk.sms), tiles, 0, 0, 0), 0)
    rc = _sm90().acestep_oob_k1(
        z.data_ptr(), h.data_ptr(), w2.data_ptr(), b2.data_ptr(), _ptr(aen), _ptr(ibn),
        out.data_ptr(), _ptr(a_next), b, l, c, sched, None, None, _stream(h),
    )
    cuda_lib.check(rc, "oobleck_sm90 k1")
    return out, a_next


# ---------------------------------------------------------------------------
# Narrow route (csrc/oobleck_generic.cu)
# ---------------------------------------------------------------------------


def _generic():
    return cuda_lib.load("oobleck_generic", _GEN_SIGNATURES)


def _check_narrow(what: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if (t.device.type != "cuda" or t.dtype not in NARROW_DTYPES or t.dtype != ts[0].dtype
                or t.dim() != 3 or not t.is_contiguous()):
            raise ValueError(f"{what}: expects contiguous bf16 or fp32 (B, L, C) CUDA tensors of one dtype, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def narrow_tile(n: int, pow2: bool = False) -> int:
    """Output channels of a narrow-route tile over n columns, 32 nt for nt in
    (1, 2, 4, 6, 8): the smallest that holds n up to 192 columns, above that
    192 or 256, whichever pads n less (`pow2`: powers of two only)."""
    if n <= 128 or pow2:
        return 32 if n <= 32 else 64 if n <= 64 else 128 if n <= 128 else 256
    return 192 if -(-n // 192) * 192 < -(-n // 256) * 256 else 256


_SMS: Dict[int, int] = {}


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _upsample_tile(b: int, l: int, npad: int, device: torch.device) -> int:
    """The upsample's CTA columns over a weight padded to npad (32-row CTAs):
    the widest power-of-two tile up to 128 (4 warps) that still gives every
    SM a CTA."""
    bn = min(128, narrow_tile(npad, pow2=True))
    while bn > 32 and -(-l // 32) * (npad // bn) * b < _sms(device):
        bn //= 2
    return bn


def narrow_kstep(dtype: torch.dtype) -> int:
    """Input channels of one K step of the narrow route: 64 bytes of them."""
    return 16 if dtype == torch.float32 else 32


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as `cvt.rna.tf32.f32` rounds a finite value (to
    nearest, ties away from zero): the route's `tf32_rna`."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_weights(w: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 weights as the narrow route's two operand parts, hi + lo ~ w:
    bf16 (hi = bf16(w), lo = bf16(w - hi)) for bf16 activations, TF32 held in
    fp32 (hi = rna(w), lo = rna(w - hi)) for fp32 ones."""
    w = w.float()
    if dtype == torch.bfloat16:
        hi = w.to(torch.bfloat16)
        return hi, (w - hi.float()).to(torch.bfloat16)
    hi = tf32_rna(w)
    return hi, tf32_rna(w - hi)


def pack_narrow(kernel: torch.Tensor, dtype: torch.dtype, pow2: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, C_in, N) conv kernel -> its (hi, lo) parts, each (K, N_pad, K_pad):
    every tap K-major per output channel, zero-padded to the narrow route's
    tile (N to `narrow_tile`, of powers of two with `pow2`, as the upsample
    takes them; C_in to `narrow_kstep`)."""
    k, ci, n = kernel.shape
    tile = narrow_tile(n, pow2)
    npad, kpad = -(-n // tile) * tile, -(-ci // narrow_kstep(dtype)) * narrow_kstep(dtype)
    w = torch.zeros((k, npad, kpad), dtype=torch.float32, device=kernel.device)
    w[:, :n, :ci] = kernel.float().permute(0, 2, 1)
    hi, lo = split_weights(w, dtype)
    return hi.contiguous(), lo.contiguous()


def _narrow_packed(kernel: torch.Tensor, dtype: torch.dtype, stride: Optional[int] = None):
    """pack_narrow of the kernel, or of its phase weights when `stride` is given."""
    if stride is None:
        return _derived(f"narrow{dtype}", (kernel,), lambda: pack_narrow(kernel, dtype))
    return _derived(f"narrow_phase{stride}{dtype}", (kernel,),
                    lambda: pack_narrow(phase_weights(kernel.float(), stride), dtype, pow2=True))


def _fp32(x: torch.Tensor) -> int:
    return int(x.dtype == torch.float32)


def _narrow_snake(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    ae, ib = _snake_consts(p)
    y = torch.empty_like(x)
    rc = _generic().acestep_gen_snake(
        x.data_ptr(), ae.data_ptr(), ib.data_ptr(), y.data_ptr(), x.numel(), x.shape[-1], _fp32(x), _stream(x)
    )
    cuda_lib.check(rc, "oobleck_generic snake")
    return y


def _narrow_unit(
    h: torch.Tensor, a: torch.Tensor, p: Dict[str, Any], dilation: int, snake_next: Optional[Dict[str, torch.Tensor]]
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One residual unit from h and a = T(Snake1(h)), one launch: h' =
    T((h + conv_k1(z)) + b2) with z = T(Snake2(conv_k7,d(a) + b1)) kept in
    shared memory, and a_next = T(snake_next(h')) when given."""
    b, l, c = h.shape
    dev = h.device
    w1h, w1l = _narrow_packed(p["conv1"]["kernel"], h.dtype)
    w2h, w2l = _narrow_packed(p["conv2"]["kernel"], h.dtype)
    ae2, ib2 = _snake_consts(p["snake2"])
    out = torch.empty_like(h)
    a_next = aen = ibn = None
    if snake_next is not None:
        a_next = torch.empty_like(h)
        aen, ibn = _snake_consts(snake_next)
    rc = _generic().acestep_gen_unit(
        a.data_ptr(), h.data_ptr(), w1h.data_ptr(), w1l.data_ptr(), _f32(p["conv1"].get("bias"), c, dev).data_ptr(),
        ae2.data_ptr(), ib2.data_ptr(), w2h.data_ptr(), w2l.data_ptr(), _f32(p["conv2"].get("bias"), c, dev).data_ptr(),
        _ptr(aen), _ptr(ibn), out.data_ptr(), _ptr(a_next), b, l, c, w1h.shape[1], w1h.shape[2],
        narrow_tile(c), dilation, _fp32(h), _stream(h),
    )
    cuda_lib.check(rc, "oobleck_generic unit")
    return out, a_next


def _narrow_units(h: torch.Tensor, a: torch.Tensor, units: Sequence[Dict[str, Any]]) -> torch.Tensor:
    for k, (p, d) in enumerate(zip(units, DILATIONS)):
        h, a = _narrow_unit(h, a, p, d, units[k + 1]["snake1"] if k + 1 < len(units) else None)
    return h


def res_units_narrow(x: torch.Tensor, unit_params: Sequence[Dict[str, Any]]) -> torch.Tensor:
    """The chain on the narrow route: the Snake launch, then one launch per
    unit (4 launches); CUDA tensors only, any C up to 1024."""
    _check_narrow("res_units_narrow", x)
    return _narrow_units(x, _narrow_snake(x, unit_params[0]["snake1"]), unit_params)


def decoder_block_narrow(x: torch.Tensor, p: Dict[str, Any], stride: int) -> torch.Tensor:
    """A decoder block on the narrow route: the Snake launch, the conv_t
    launch with the first unit's Snake1, then one launch per unit (5
    launches); CUDA tensors only, any widths up to 512 output channels."""
    _check_narrow("decoder_block_narrow", x)
    b, l, ci = x.shape
    ct, units = p["conv_t1"], (p["res_unit1"], p["res_unit2"], p["res_unit3"])
    co = ct["kernel"].shape[2]
    a0 = _narrow_snake(x, p["snake1"])
    ae, ib = _snake_consts(units[0]["snake1"])
    wh, wl = _narrow_packed(ct["kernel"], x.dtype, stride)
    y = torch.empty((b, l * stride, co), dtype=x.dtype, device=x.device)
    a1 = torch.empty_like(y)
    rc = _generic().acestep_gen_upsample(
        a0.data_ptr(), wh.data_ptr(), wl.data_ptr(), _f32(ct.get("bias"), co, x.device).data_ptr(),
        ae.data_ptr(), ib.data_ptr(), y.data_ptr(), a1.data_ptr(), b, l, ci, co, stride, wh.shape[1], wh.shape[2],
        _upsample_tile(b, l, wh.shape[1], x.device), _fp32(x), _stream(x),
    )
    cuda_lib.check(rc, "oobleck_generic upsample")
    return _narrow_units(y, a1, units)


def res_units_kernel(x: torch.Tensor, unit_params: Sequence[Dict[str, Any]]) -> torch.Tensor:
    """3-residual-unit chain (dilations 1/3/9) on (B, L, C) NLC activations.
    On the card, bf16 at C in CHAIN_CHANNELS: a Snake launch for the first
    unit's Snake1, then per unit one fused launch at C <= 256, else the k7
    (on the stream-K schedule at multiples of 256) and the k1 with the next
    unit's Snake1 in its epilogue (4 or 7 launches); any other C up to 1024,
    or fp32: the narrow route (4 launches)."""
    if x.device.type == "cpu":
        return res_units_plain(x, unit_params)
    c = x.shape[-1]
    if x.dtype != torch.bfloat16 or c not in CHAIN_CHANNELS:
        if c > CHAIN_MAX_CHANNELS:
            raise ValueError(f"res_units_kernel: {c} channels; the chain takes at most {CHAIN_MAX_CHANNELS}")
        with torch.cuda.device(x.device):
            x = res_units_narrow(x, unit_params)
        res_units_kernel.narrow_launches += 1
    else:
        x = _res_units_sm90(x, unit_params)
    res_units_kernel.launches += 1
    return x


def _res_units_sm90(x: torch.Tensor, unit_params: Sequence[Dict[str, Any]]) -> torch.Tensor:
    c = x.shape[-1]
    _check_sm90("res_units_kernel", c, x, channels=CHAIN_CHANNELS)
    split = c > 256 and c % 256 == 0
    if split and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("res_units_kernel: a CUDA graph cannot replay the stream-K launches' epochs")
    with torch.cuda.device(x.device):
        sk = _streamk(x) if split else None
        a = _snake_launch(x, *_snake_consts(unit_params[0]["snake1"]))
        for k, (p, d) in enumerate(zip(unit_params, DILATIONS)):
            nxt = unit_params[k + 1]["snake1"] if k + 1 < len(unit_params) else None
            if c <= 256:
                x, a = res_unit_sm90(x, a, p, d, nxt)
            else:
                x, a = _k1(_k7(a, p, d, sk), x, p, nxt, sk)
    return x


res_units_kernel.launches = 0
res_units_kernel.narrow_launches = 0


def decoder_block_kernel(x: torch.Tensor, p: Dict[str, Any], stride: int) -> torch.Tensor:
    """One decoder block (B, L, Ci) -> (B, L*stride, Co); stride even. On the
    card, bf16 with Co in SM90_CHANNELS and Ci a multiple of 128: the Hopper
    route (5 or 8 launches); any other Co up to 512, or fp32: the narrow route
    (5 launches)."""
    if stride % 2:
        raise ValueError("Oobleck decoder strides are even")
    if x.device.type == "cpu":
        return decoder_block_plain(x, p, stride)
    co = p["conv_t1"]["kernel"].shape[2]
    if x.dtype != torch.bfloat16 or not decoder_block_takes(x.shape[-1], co):
        if co > BLOCK_MAX_CHANNELS:
            raise ValueError(f"decoder_block_kernel: {co} output channels; the block takes at most "
                             f"{BLOCK_MAX_CHANNELS}")
        with torch.cuda.device(x.device):
            y = decoder_block_narrow(x, p, stride)
        decoder_block_kernel.narrow_launches += 1
    else:
        y = _decoder_block_sm90(x, p, stride)
    decoder_block_kernel.launches += 1
    return y


def _decoder_block_sm90(x: torch.Tensor, p: Dict[str, Any], stride: int) -> torch.Tensor:
    _check_act(x, "decoder_block_kernel")
    units = (p["res_unit1"], p["res_unit2"], p["res_unit3"])
    _check_sm90("decoder_block_kernel", p["conv_t1"]["kernel"].shape[2], x)
    with torch.cuda.device(x.device):
        a = _snake_launch(x, *_snake_consts(p["snake1"]))
        y, a = upsample_sm90(a, p["conv_t1"], stride, units[0]["snake1"])
        for k, (u, d) in enumerate(zip(units, DILATIONS)):
            y, a = res_unit_sm90(y, a, u, d, units[k + 1]["snake1"] if k + 1 < len(units) else None)
    return y


decoder_block_kernel.launches = 0
decoder_block_kernel.narrow_launches = 0
