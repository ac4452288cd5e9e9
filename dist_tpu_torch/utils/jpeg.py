"""A baseline JPEG writer for one-component 8-bit images, the port's
stand-in for ``cv2.imwrite(path, img)`` of a 2-D ``uint8`` array at
OpenCV's defaults (the JAX package's ``utils/visualization.py`` writes
its feature maps so).

It writes the bytes libjpeg-turbo writes there: JFIF 1.01 (APP0), one
quantization table at quality 95, a baseline frame (SOF0) of one
component, the standard luminance Huffman tables (a DHT each), one scan,
no restart markers. The image is extended to a multiple of 8 by
replicating its last column and row; each 8 x 8 block is level-shifted
by 128, transformed by the integer ``islow`` DCT (``jfdctint.c``) and
quantized by libjpeg-turbo's reciprocal multiply (``jcdctmgr.c``); the
coefficients are coded in zig-zag order, the DC as differences and the
AC as runs with ZRL and EOB (``jchuff.c``), with ``0xFF 0x00`` stuffing
and 1-bits padding the last byte.

Everything up to the bytes is integer arithmetic on torch tensors, with
no loop over blocks: the images of a batch are coded together, on
whatever device they lie (a card or the CPU), and the bytes are the
same on either.
"""

import numpy as np
import torch

QUALITY = 95

# ITU T.81 Annex K: the luminance quantization table (natural order) and
# the luminance Huffman tables (code counts by length 1..16, symbols)
_LUMA_Q = (
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99)
_DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
_DC_VALS = tuple(range(12))
_AC_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d)
_AC_VALS = (
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa)
# the natural (row-major) index of each zig-zag position
ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)

# jfdctint.c's fixed-point constants (CONST_BITS 13) and scalings
_CONST_BITS, _PASS1_BITS = 13, 2
(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847, _F1961,
 _F2053, _F2562, _F3072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299,
                            15137, 16069, 16819, 20995, 25172)
_ZRL, _EOB = 0xF0, 0x00


def quant_table():
    """libjpeg's ``jpeg_set_quality(QUALITY, force_baseline=TRUE)``
    scaling of the luminance table, natural order."""
    scale = 5000 // QUALITY if QUALITY < 50 else 200 - 2 * QUALITY
    return tuple(min(max((q * scale + 50) // 100, 1), 255) for q in _LUMA_Q)


def _huffman(bits, vals):
    """(code, length) of each symbol: ``jpeg_make_c_derived_tbl``'s
    canonical codes."""
    sizes = [n for n, count in enumerate(bits, 1) for _ in range(count)]
    code, size, codes = 0, sizes[0], []
    for s in sizes:
        code <<= s - size
        size = s
        codes.append(code)
        code += 1
    table_code, table_size = [0] * 256, [0] * 256
    for v, c, s in zip(vals, codes, sizes):
        table_code[v], table_size[v] = c, s
    return table_code, table_size


def _reciprocal(divisor):
    """(reciprocal, correction, shift) of libjpeg-turbo's
    ``compute_reciprocal`` for a 16-bit ``DCTELEM``: ``((|x| + c) * f)
    >> r`` is ``|x|`` divided by ``divisor``, rounded half up."""
    b = divisor.bit_length() - 1
    r = 16 + b
    fq, fr = divmod(1 << r, divisor)
    c = divisor // 2
    if fr == 0:
        fq >>= 1
        r -= 1
    elif fr <= divisor // 2:
        c += 1
    else:
        fq += 1
    return fq, c, r


class _Tables:
    """The coder's tables as tensors on one device."""

    def __init__(self, device):
        q = quant_table()
        recip = [_reciprocal(v << 3) for v in q]   # islow's output is x8
        long = dict(dtype=torch.int64, device=device)
        self.fq = torch.tensor([f for f, _, _ in recip], **long)
        self.corr = torch.tensor([c for _, c, _ in recip], **long)
        self.shift = torch.tensor([r for _, _, r in recip], **long)
        self.zigzag = torch.tensor(ZIGZAG, **long)
        dc_code, dc_size = _huffman(_DC_BITS, _DC_VALS)
        ac_code, ac_size = _huffman(_AC_BITS, _AC_VALS)
        self.dc_code = torch.tensor(dc_code, **long)
        self.dc_size = torch.tensor(dc_size, **long)
        self.ac_code = torch.tensor(ac_code, **long)
        self.ac_size = torch.tensor(ac_size, **long)
        zrl, zrl_size = ac_code[_ZRL], ac_size[_ZRL]
        # 0 to 3 ZRLs (a run of at most 62 zeros) as one bit string
        self.zrl_code = torch.tensor(
            [sum(zrl << (zrl_size * i) for i in range(n)) for n in range(4)],
            **long)
        self.zrl_size = torch.tensor([zrl_size * n for n in range(4)], **long)
        self.eob = (ac_code[_EOB], ac_size[_EOB])
        # the magnitude category (bit length) of 0 .. 2^15 - 1
        self.nbits = torch.tensor(
            [int(v).bit_length() for v in range(1 << 15)], **long)


_TABLES = {}


def _tables(device):
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = _Tables(device)
    return _TABLES[key]


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, first):
    """One pass of ``jpeg_fdct_islow`` over the eight inputs ``d`` (the
    rows' samples in the first pass, the columns' in the second)."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    if first:
        out0 = (tmp10 + tmp11) << _PASS1_BITS
        out4 = (tmp10 - tmp11) << _PASS1_BITS
        n = _CONST_BITS - _PASS1_BITS
    else:
        out0 = _descale(tmp10 + tmp11, _PASS1_BITS)
        out4 = _descale(tmp10 - tmp11, _PASS1_BITS)
        n = _CONST_BITS + _PASS1_BITS
    z1 = (tmp12 + tmp13) * _F0541
    out2 = _descale(z1 + tmp13 * _F0765, n)
    out6 = _descale(z1 - tmp12 * _F1847, n)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5 = tmp4 * _F0298, tmp5 * _F2053
    tmp6, tmp7 = tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    out7 = _descale(tmp4 + z1 + z3, n)
    out5 = _descale(tmp5 + z2 + z4, n)
    out3 = _descale(tmp6 + z2 + z3, n)
    out1 = _descale(tmp7 + z1 + z4, n)
    return [out0, out1, out2, out3, out4, out5, out6, out7]


def coefficients(images):
    """The quantized DCT coefficients of ``images`` (``(N, H, W)``
    ``uint8``), ``(N, blocks, 64)`` int64 in zig-zag order, the blocks in
    raster order."""
    t = _tables(images.device)
    n, h, w = images.shape
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    x = images.to(torch.int64)
    # the last column and row replicated to a multiple of 8
    x = torch.cat([x, x[:, :, -1:].expand(n, h, wp - w)], dim=2)
    x = torch.cat([x, x[:, -1:, :].expand(n, hp - h, wp)], dim=1)
    blocks = (x.reshape(n, hp // 8, 8, wp // 8, 8).permute(0, 1, 3, 2, 4)
              .reshape(n, -1, 8, 8)) - 128
    rows = torch.stack(_fdct_1d(blocks.unbind(-1), True), dim=-1)
    coef = torch.stack(_fdct_1d(rows.unbind(-2), False), dim=-2)
    coef = coef.reshape(n, -1, 64)
    mag = ((coef.abs() + t.corr) * t.fq) >> t.shift
    quant = torch.where(coef < 0, -mag, mag)
    return quant.index_select(2, t.zigzag)


def _items(coef, t):
    """Each block's bit strings in stream order, ``(values, lengths)`` of
    shape ``(N, blocks, 128)`` (zero length where there is none): the DC
    difference's code and bits; for each AC position its ZRLs and its
    code and bits where the coefficient is not zero; the EOB where
    zeros end the block."""
    n, nb, _ = coef.shape
    dc = coef[..., 0]
    diff = dc - torch.cat([dc.new_zeros(n, 1), dc[:, :-1]], dim=1)
    ac = coef[..., 1:]

    def bits(v):
        size = t.nbits[v.abs()]
        raw = torch.where(v < 0, v - 1, v) & ((1 << size) - 1)
        return size, raw

    dc_n, dc_raw = bits(diff)
    dc_len = t.dc_size[dc_n] + dc_n
    dc_val = (t.dc_code[dc_n] << dc_n) | dc_raw
    nz = ac != 0
    pos = torch.arange(1, 64, device=coef.device)
    last = torch.where(nz, pos, 0).cummax(dim=-1).values
    prev = torch.cat([last.new_zeros(n, nb, 1), last[..., :-1]], dim=-1)
    run = pos - prev - 1
    ac_n, ac_raw = bits(ac)
    sym = ((run & 15) << 4) + ac_n
    code_len = torch.where(nz, t.ac_size[sym] + ac_n, 0)
    code_val = torch.where(nz, (t.ac_code[sym] << ac_n) | ac_raw, 0)
    zrl = torch.where(nz, run >> 4, 0)
    eob = last[..., -1] < 63
    values = torch.cat([
        dc_val[..., None],
        torch.stack([t.zrl_code[zrl], code_val], dim=-1).reshape(n, nb, -1),
        torch.where(eob, t.eob[0], 0)[..., None]], dim=-1)
    lengths = torch.cat([
        dc_len[..., None],
        torch.stack([t.zrl_size[zrl], code_len], dim=-1).reshape(n, nb, -1),
        torch.where(eob, t.eob[1], 0)[..., None]], dim=-1)
    return values, lengths


def _entropy_coded(coef, t):
    """The entropy-coded segment of each image, stuffed and padded:
    (bytes ``uint8`` on the device, each image's start and end in it)."""
    n = coef.shape[0]
    values, lengths = _items(coef, t)
    values, lengths = values.reshape(n, -1), lengths.reshape(n, -1)
    total = lengths.sum(dim=1)                         # bits an image
    nbytes = (total + 7) >> 3
    starts = torch.cumsum(nbytes, 0) - nbytes          # image's first byte
    keep = lengths.reshape(-1) > 0
    val, length = values.reshape(-1)[keep], lengths.reshape(-1)[keep]
    image = torch.arange(n, device=coef.device).repeat_interleave(
        (lengths > 0).sum(dim=1))
    within = torch.cumsum(lengths, dim=1) - lengths    # exclusive, a row
    bit = within.reshape(-1)[keep] + (starts << 3)[image]
    size = int(nbytes.sum()) + 5
    out = torch.zeros(size, dtype=torch.int64, device=coef.device)
    first, offset = bit >> 3, bit & 7
    window = val << (40 - offset - length)             # 5 bytes from first
    for j in range(5):
        out.index_add_(0, first + j, (window >> (32 - 8 * j)) & 0xFF)
    # 1-bits to the end of the last byte
    rem = total & 7
    pad = (rem > 0).nonzero().flatten()
    out.index_add_(0, starts[pad] + (total[pad] >> 3),
                   (1 << (8 - rem[pad])) - 1)
    out = out[:size - 5]
    # a 0x00 after every 0xFF
    ff = out == 0xFF
    step = 1 + ff.to(torch.int64)
    where = torch.cumsum(step, 0) - step
    stuffed = torch.zeros(int(step.sum()), dtype=torch.uint8,
                          device=coef.device)
    stuffed[where] = out.to(torch.uint8)
    begin = where[starts]
    end = torch.where(nbytes > 0, where[starts + nbytes - 1]
                      + step[starts + nbytes - 1], begin)
    return stuffed, begin, end


def _headers(h, w):
    """The markers before the entropy-coded segment: SOI, APP0 (JFIF
    1.01, no units, density 1 x 1, no thumbnail), DQT, SOF0, the DC and
    AC tables' DHTs, SOS."""
    def segment(marker, body):
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") \
            + body

    q = quant_table()
    out = b"\xff\xd8"
    out += segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += segment(0xDB, bytes([0]) + bytes(q[i] for i in ZIGZAG))
    out += segment(0xC0, bytes([8]) + h.to_bytes(2, "big")
                   + w.to_bytes(2, "big") + bytes([1, 1, 0x11, 0]))
    out += segment(0xC4, bytes([0x00]) + bytes(_DC_BITS) + bytes(_DC_VALS))
    out += segment(0xC4, bytes([0x10]) + bytes(_AC_BITS) + bytes(_AC_VALS))
    out += segment(0xDA, bytes([1, 1, 0x00, 0, 63, 0]))
    return out


def encode(images):
    """The JPEG files of ``images``, a ``uint8`` batch ``(N, H, W)`` (a
    tensor on any device, or a numpy array), as a list of ``bytes``."""
    if not torch.is_tensor(images):
        images = torch.from_numpy(np.ascontiguousarray(images))
    if images.dtype != torch.uint8 or images.dim() != 3:
        raise ValueError(f"encode takes (N, H, W) uint8 images; got "
                         f"{tuple(images.shape)} {images.dtype}")
    n, h, w = images.shape
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"a JPEG frame is at most 65535 a side; got {h}x{w}")
    t = _tables(images.device)
    data, begin, end = _entropy_coded(coefficients(images), t)
    data = data.cpu().numpy()
    head = _headers(h, w)
    return [head + data[b:e].tobytes() + b"\xff\xd9"
            for b, e in zip(begin.tolist(), end.tolist())]

