"""Dolby Vision RPU bitstream parsing.

Counterpart of libplacebo_tpu/utils/dolbyvision.py (numpy only, copied
so that the port imports nothing of the reference package).

The reference delegates RPU parsing to libdovi and only extracts L1
brightness metadata (src/utils/dolbyvision.c:26-63) plus the
libdovi/ffmpeg-parsed struct mapping (utils/libav_internal.h:896-945
pl_map_dovi_metadata).  No such library exists here, so this module
implements the RPU payload parser itself — the `vdr_rpu_data` reshaping
curves (pivots, polynomial/MMR coefficients), the `vdr_dm_data` color
matrices, and the L1/L2/L6 extension blocks — following the bitstream
layout implemented publicly in FFmpeg's libavcodec/dovi_rpu.c and
quietvoid's dovi_tool.  Single-layer profiles (5/8.x) map fully to
reshaping metadata; dual-layer profile-7 RPUs (FEL/MEL) have their NLQ
header + rpu_data_nlq payload parsed and preserved (nlq_method_idc,
pivots, per-component offset/vdr_in_max/deadzone), but the renderer —
like the reference, which never processes the enhancement layer —
applies only the base-layer reshaping curves.

A writer (`write_rpu`) mirrors the parser for round-trip tests and for
synthesizing RPUs.

Entry points:
  parse_rpu(buf)            -> DoviRpu (full parsed payload)
  rpu_to_dovi(rpu)          -> core.colorspace.DoviMetadata (reshape data
                               scaled exactly like pl_map_dovi_metadata)
  hdr_metadata_from_rpu(hdr, buf) -> HdrMetadata with L1 brightness
                               applied (reference
                               pl_hdr_metadata_from_dovi_rpu)
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np

from ..core.colorspace import DoviMetadata, HdrMetadata

__all__ = ["DoviRpu", "RpuNlq", "parse_rpu", "write_rpu", "rpu_to_dovi",
           "hdr_metadata_from_rpu", "RpuError"]


class RpuError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Bit I/O (exp-Golomb capable)
# ---------------------------------------------------------------------------

class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0               # bit position

    def u(self, n: int) -> int:
        out = 0
        for _ in range(n):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise RpuError("RPU truncated")
            bit = (self.data[byte] >> (7 - (self.pos & 7))) & 1
            out = (out << 1) | bit
            self.pos += 1
        return out

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 64:
                raise RpuError("invalid exp-Golomb code")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) >> 1 if k & 1 else -(k >> 1)

    def align(self):
        self.pos = (self.pos + 7) & ~7


class _BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def u(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def ue(self, value: int):
        assert value >= 0
        v = value + 1
        n = v.bit_length()
        self.u(0, n - 1)
        self.u(v, n)

    def se(self, value: int):
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def align(self):
        while len(self.bits) % 8:
            self.bits.append(0)

    def bytes(self) -> bytes:
        self.align()
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for bit in self.bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def _strip_emulation(data: bytes) -> bytes:
    """Remove 0x000003 emulation prevention bytes (NAL ebsp -> rbsp)."""
    out = bytearray()
    zeros = 0
    for b in data:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


# ---------------------------------------------------------------------------
# Parsed structures
# ---------------------------------------------------------------------------

@dataclass
class RpuCurve:
    """One component's reshaping curve (raw fixed-point values)."""
    num_pivots: int = 2
    pivots: Tuple[int, ...] = (0, 0)
    mapping_idc: Tuple[int, ...] = ()       # 0 = polynomial, 1 = MMR
    poly_order: Tuple[int, ...] = ()
    poly_coef: Tuple[Tuple[int, ...], ...] = ()
    mmr_order: Tuple[int, ...] = ()
    mmr_constant: Tuple[int, ...] = ()
    mmr_coef: Tuple = ()                    # per piece: (order, 7) ints


@dataclass
class RpuNlq:
    """Non-linear quantization data for the enhancement layer
    (rpu_data_nlq; FFmpeg dovi_rpu.c parse_nlq / dovi_tool
    rpu_data_nlq.rs).  Raw fixed-point values; one entry per component.
    The reference never consumes these (the EL is not processed,
    utils/dolbyvision.c) — they are preserved for round-trips and
    inspection."""
    method_idc: int = 0                     # 0 = LINEAR_DZ
    pivots: Tuple[int, int] = (0, 0)        # u(bl_bit_depth) x2
    nlq_offset: Tuple[int, ...] = (0, 0, 0)
    vdr_in_max: Tuple[int, ...] = (0, 0, 0)
    dz_slope: Tuple[int, ...] = (0, 0, 0)   # linear_deadzone_slope
    dz_threshold: Tuple[int, ...] = (0, 0, 0)


@dataclass
class RpuExtBlock:
    level: int = 0
    # level 1
    min_pq: int = 0
    max_pq: int = 0
    avg_pq: int = 0
    # level 2
    target_max_pq: int = 0
    trim_slope: int = 2048
    trim_offset: int = 2048
    trim_power: int = 2048
    trim_chroma_weight: int = 2048
    trim_saturation_gain: int = 2048
    ms_weight: int = 2048
    # level 3 (CM v4.0: offsets on top of the L1 values)
    min_pq_offset: int = 2048
    max_pq_offset: int = 2048
    avg_pq_offset: int = 2048
    # level 5 (active area)
    active_area: Tuple[int, int, int, int] = (0, 0, 0, 0)  # l, r, t, b
    # level 6
    max_luminance: int = 0
    min_luminance: int = 0
    max_cll: int = 0
    max_fall: int = 0
    # level 254 (CM v4.0 mode marker)
    dm_mode: int = 0
    dm_version_index: int = 0


@dataclass
class DoviRpu:
    """Parsed RPU (single-layer subset of the rpu_data payload)."""
    rpu_type: int = 2
    rpu_format: int = 0
    vdr_rpu_profile: int = 1
    vdr_rpu_level: int = 0
    coef_log2_denom: int = 23
    vdr_rpu_normalized_idc: int = 1
    bl_video_full_range_flag: bool = False
    bl_bit_depth: int = 10
    el_bit_depth: int = 10
    vdr_bit_depth: int = 12
    disable_residual_flag: bool = True
    curves: Tuple[RpuCurve, RpuCurve, RpuCurve] = (
        None, None, None)  # type: ignore
    # vdr_dm_data
    dm_metadata_present: bool = False
    scene_refresh_flag: int = 0
    ycc_to_rgb_matrix: Tuple[int, ...] = (8192, 0, 12900, 8192, -1534,
                                          -3836, 8192, 15201, 0)  # /8192
    ycc_to_rgb_offset: Tuple[int, ...] = (0, 1 << 27, 1 << 27)    # /2^28
    rgb_to_lms_matrix: Tuple[int, ...] = (5845, 9702, 837, 2568, 12256,
                                          1561, 0, 679, 15705)    # /16384
    signal_eotf: int = 65535
    signal_bit_depth: int = 12
    signal_color_space: int = 0
    signal_full_range_flag: int = 1
    source_min_pq: int = 62
    source_max_pq: int = 3696
    source_diagonal: int = 42
    ext_blocks: Tuple[RpuExtBlock, ...] = ()
    nlq: Optional[RpuNlq] = None            # profile-7 dual-layer only


# ---------------------------------------------------------------------------
# Parser (bitstream layout per FFmpeg dovi_rpu.c / dovi_tool)
# ---------------------------------------------------------------------------

def _read_coef(r: _BitReader, denom: int, signed: bool) -> int:
    ipart = r.se() if signed else r.ue()
    fpart = r.u(denom)
    return ipart * (1 << denom) + fpart


def parse_rpu(buf: bytes) -> DoviRpu:
    """Parse an unspec-62 NAL RPU payload (with or without the NAL
    header byte pair and emulation-prevention bytes)."""
    data = bytes(buf)
    # accept a leading HEVC NAL header for unspec 62 (0x7C 0x01)
    if len(data) >= 2 and (data[0] >> 1) == 62:
        data = data[2:]
    data = _strip_emulation(data)
    r = _BitReader(data)

    prefix = r.u(8)
    if prefix != 25:
        raise RpuError(f"bad rpu_nal_prefix {prefix}")
    rpu = DoviRpu()
    rpu.rpu_type = r.u(6)
    rpu.rpu_format = r.u(11)
    if rpu.rpu_type != 2:
        raise RpuError(f"unsupported rpu_type {rpu.rpu_type}")

    rpu.vdr_rpu_profile = r.u(4)
    rpu.vdr_rpu_level = r.u(4)
    if r.u(1):                              # vdr_seq_info_present_flag
        r.u(1)                              # chroma_resampling_explicit
        coef_data_type = r.u(2)
        if coef_data_type != 0:
            raise RpuError("only fixed-point coefficients supported")
        rpu.coef_log2_denom = r.ue()
        rpu.vdr_rpu_normalized_idc = r.u(2)
        rpu.bl_video_full_range_flag = bool(r.u(1))
        if (rpu.rpu_format & 0x700) == 0:
            rpu.bl_bit_depth = r.ue() + 8
            rpu.el_bit_depth = r.ue() + 8
            rpu.vdr_bit_depth = r.ue() + 8
            r.u(1)                          # spatial_resampling_filter
            r.u(3)                          # reserved
            r.u(1)                          # el_spatial_resampling
            rpu.disable_residual_flag = bool(r.u(1))

    dm_present = bool(r.u(1))
    use_prev = bool(r.u(1))
    if use_prev:
        raise RpuError("use_prev_vdr_rpu not supported (stateless parser)")
    r.ue()                                  # vdr_rpu_id
    r.ue()                                  # mapping_color_space
    r.ue()                                  # mapping_chroma_format_idc

    curves = []
    for c in range(3):
        num_pivots = r.ue() + 2
        pivots = [r.u(rpu.bl_bit_depth)]
        for _ in range(num_pivots - 1):
            pivots.append(pivots[-1] + r.u(rpu.bl_bit_depth))
        curves.append(RpuCurve(num_pivots=num_pivots,
                               pivots=tuple(pivots)))

    el_nlq = (rpu.rpu_format & 0x700) == 0 and not rpu.disable_residual_flag
    if el_nlq:                              # profile-7 dual-layer header
        nlq = RpuNlq()
        nlq.method_idc = r.u(3)
        nlq.pivots = (r.u(rpu.bl_bit_depth), r.u(rpu.bl_bit_depth))
        rpu.nlq = nlq

    r.ue()                                  # num_x_partitions_minus1
    r.ue()                                  # num_y_partitions_minus1

    for c in range(3):
        cur = curves[c]
        idcs, porders, pcoefs = [], [], []
        morders, mconsts, mcoefs = [], [], []
        for _ in range(cur.num_pivots - 1):
            idc = r.ue()
            idcs.append(idc)
            if idc == 0:                    # polynomial
                order = r.ue() + 1
                if order > 2:
                    raise RpuError(f"poly order {order} > 2")
                if order == 1 and r.u(1):
                    raise RpuError("linear_interp not supported")
                coefs = [_read_coef(r, rpu.coef_log2_denom, signed=True)
                         for _ in range(order + 1)]
                porders.append(order)
                pcoefs.append(tuple(coefs))
                morders.append(0)
                mconsts.append(0)
                mcoefs.append(())
            elif idc == 1:                  # MMR
                order = r.u(2) + 1
                const = _read_coef(r, rpu.coef_log2_denom, signed=True)
                rows = tuple(
                    tuple(_read_coef(r, rpu.coef_log2_denom, signed=True)
                          for _ in range(7))
                    for _ in range(order))
                porders.append(0)
                pcoefs.append(())
                morders.append(order)
                mconsts.append(const)
                mcoefs.append(rows)
            else:
                raise RpuError(f"unknown mapping_idc {idc}")
        cur.mapping_idc = tuple(idcs)
        cur.poly_order = tuple(porders)
        cur.poly_coef = tuple(pcoefs)
        cur.mmr_order = tuple(morders)
        cur.mmr_constant = tuple(mconsts)
        cur.mmr_coef = tuple(mcoefs)
    rpu.curves = tuple(curves)

    if el_nlq:                              # rpu_data_nlq payload
        nlq = rpu.nlq
        offs, inmax, slopes, thrs = [], [], [], []
        for _ in range(3):
            offs.append(r.u(rpu.el_bit_depth))
            inmax.append(_read_coef(r, rpu.coef_log2_denom, signed=False))
            if nlq.method_idc == 0:         # LINEAR_DZ
                slopes.append(_read_coef(r, rpu.coef_log2_denom,
                                         signed=False))
                thrs.append(_read_coef(r, rpu.coef_log2_denom,
                                       signed=False))
            else:
                slopes.append(0)
                thrs.append(0)
        nlq.nlq_offset = tuple(offs)
        nlq.vdr_in_max = tuple(inmax)
        nlq.dz_slope = tuple(slopes)
        nlq.dz_threshold = tuple(thrs)

    rpu.dm_metadata_present = dm_present
    if dm_present:
        r.ue()                              # affected_dm_metadata_id
        r.ue()                              # current_dm_metadata_id
        rpu.scene_refresh_flag = r.ue()
        rpu.ycc_to_rgb_matrix = tuple(
            _signed(r.u(16), 16) for _ in range(9))
        rpu.ycc_to_rgb_offset = tuple(r.u(32) for _ in range(3))
        rpu.rgb_to_lms_matrix = tuple(
            _signed(r.u(16), 16) for _ in range(9))
        rpu.signal_eotf = r.u(16)
        r.u(16)                             # signal_eotf_param0
        r.u(16)                             # signal_eotf_param1
        r.u(32)                             # signal_eotf_param2
        rpu.signal_bit_depth = r.u(5)
        rpu.signal_color_space = r.u(2)
        r.u(2)                              # signal_chroma_format
        rpu.signal_full_range_flag = r.u(2)
        rpu.source_min_pq = r.u(12)
        rpu.source_max_pq = r.u(12)
        rpu.source_diagonal = r.u(10)
        n_ext = r.ue()
        blocks = []
        if n_ext:
            r.align()
            for _ in range(n_ext):
                blocks.append(_parse_ext_block(r))
        rpu.ext_blocks = tuple(blocks)
    return rpu


def _signed(v: int, bits: int) -> int:
    return v - (1 << bits) if v >= (1 << (bits - 1)) else v


def _parse_ext_block(r: _BitReader) -> RpuExtBlock:
    length = r.ue()
    level = r.u(8)
    end = r.pos + length * 8
    blk = RpuExtBlock(level=level)
    if level == 1:
        blk.min_pq = r.u(12)
        blk.max_pq = r.u(12)
        blk.avg_pq = r.u(12)
    elif level == 2:
        blk.target_max_pq = r.u(12)
        blk.trim_slope = r.u(12)
        blk.trim_offset = r.u(12)
        blk.trim_power = r.u(12)
        blk.trim_chroma_weight = r.u(12)
        blk.trim_saturation_gain = r.u(12)
        blk.ms_weight = _signed(r.u(13), 13)
    elif level == 3:
        blk.min_pq_offset = r.u(12)
        blk.max_pq_offset = r.u(12)
        blk.avg_pq_offset = r.u(12)
    elif level == 5:
        blk.active_area = tuple(r.u(13) for _ in range(4))
    elif level == 6:
        blk.max_luminance = r.u(16)
        blk.min_luminance = r.u(16)
        blk.max_cll = r.u(16)
        blk.max_fall = r.u(16)
    elif level == 254:
        blk.dm_mode = r.u(8)
        blk.dm_version_index = r.u(8)
    if r.pos > end:
        raise RpuError(f"ext block level {level} overran its length")
    r.pos = end                             # skip unparsed payload bits
    return blk


# ---------------------------------------------------------------------------
# Writer (round-trip mirror of the parser)
# ---------------------------------------------------------------------------

def _write_coef(w: _BitWriter, value: int, denom: int):
    ipart = value >> denom
    fpart = value - (ipart << denom)
    w.se(ipart)
    w.u(fpart, denom)


def _write_ue_coef(w: _BitWriter, value: int, denom: int):
    w.ue(value >> denom)
    w.u(value & ((1 << denom) - 1), denom)


def write_rpu(rpu: DoviRpu) -> bytes:
    w = _BitWriter()
    w.u(25, 8)
    w.u(rpu.rpu_type, 6)
    w.u(rpu.rpu_format, 11)
    w.u(rpu.vdr_rpu_profile, 4)
    w.u(rpu.vdr_rpu_level, 4)
    w.u(1, 1)                               # vdr_seq_info_present
    w.u(0, 1)
    w.u(0, 2)                               # fixed-point coefficients
    w.ue(rpu.coef_log2_denom)
    w.u(rpu.vdr_rpu_normalized_idc, 2)
    w.u(int(rpu.bl_video_full_range_flag), 1)
    if (rpu.rpu_format & 0x700) == 0:
        w.ue(rpu.bl_bit_depth - 8)
        w.ue(rpu.el_bit_depth - 8)
        w.ue(rpu.vdr_bit_depth - 8)
        w.u(0, 1)
        w.u(0, 3)
        w.u(0, 1)
        w.u(int(rpu.disable_residual_flag), 1)
    w.u(int(rpu.dm_metadata_present), 1)
    w.u(0, 1)                               # use_prev_vdr_rpu
    w.ue(0)                                 # vdr_rpu_id
    w.ue(0)                                 # mapping_color_space
    w.ue(0)                                 # mapping_chroma_format_idc
    for cur in rpu.curves:
        w.ue(cur.num_pivots - 2)
        w.u(cur.pivots[0], rpu.bl_bit_depth)
        for a, b in zip(cur.pivots, cur.pivots[1:]):
            w.u(b - a, rpu.bl_bit_depth)
    el_nlq = (rpu.rpu_format & 0x700) == 0 and not rpu.disable_residual_flag
    if el_nlq:
        nlq = rpu.nlq or RpuNlq()
        w.u(nlq.method_idc, 3)
        w.u(nlq.pivots[0], rpu.bl_bit_depth)
        w.u(nlq.pivots[1], rpu.bl_bit_depth)
    w.ue(0)                                 # num_x_partitions_minus1
    w.ue(0)                                 # num_y_partitions_minus1
    for cur in rpu.curves:
        for i in range(cur.num_pivots - 1):
            w.ue(cur.mapping_idc[i])
            if cur.mapping_idc[i] == 0:
                order = cur.poly_order[i]
                w.ue(order - 1)
                if order == 1:
                    w.u(0, 1)               # linear_interp_flag
                for k in range(order + 1):
                    _write_coef(w, cur.poly_coef[i][k], rpu.coef_log2_denom)
            else:
                w.u(cur.mmr_order[i] - 1, 2)
                _write_coef(w, cur.mmr_constant[i], rpu.coef_log2_denom)
                for row in cur.mmr_coef[i]:
                    for v in row:
                        _write_coef(w, v, rpu.coef_log2_denom)
    if el_nlq:
        nlq = rpu.nlq or RpuNlq()
        for c in range(3):
            w.u(nlq.nlq_offset[c], rpu.el_bit_depth)
            _write_ue_coef(w, nlq.vdr_in_max[c], rpu.coef_log2_denom)
            if nlq.method_idc == 0:
                _write_ue_coef(w, nlq.dz_slope[c], rpu.coef_log2_denom)
                _write_ue_coef(w, nlq.dz_threshold[c],
                               rpu.coef_log2_denom)
    if rpu.dm_metadata_present:
        w.ue(0)
        w.ue(0)
        w.ue(rpu.scene_refresh_flag)
        for v in rpu.ycc_to_rgb_matrix:
            w.u(v & 0xFFFF, 16)
        for v in rpu.ycc_to_rgb_offset:
            w.u(v, 32)
        for v in rpu.rgb_to_lms_matrix:
            w.u(v & 0xFFFF, 16)
        w.u(rpu.signal_eotf, 16)
        w.u(0, 16)
        w.u(0, 16)
        w.u(0, 32)
        w.u(rpu.signal_bit_depth, 5)
        w.u(rpu.signal_color_space, 2)
        w.u(0, 2)
        w.u(rpu.signal_full_range_flag, 2)
        w.u(rpu.source_min_pq, 12)
        w.u(rpu.source_max_pq, 12)
        w.u(rpu.source_diagonal, 10)
        w.ue(len(rpu.ext_blocks))
        if rpu.ext_blocks:
            w.align()
            for blk in rpu.ext_blocks:
                _write_ext_block(w, blk)
    return w.bytes()


def _write_ext_block(w: _BitWriter, blk: RpuExtBlock):
    payload = _BitWriter()
    if blk.level == 1:
        payload.u(blk.min_pq, 12)
        payload.u(blk.max_pq, 12)
        payload.u(blk.avg_pq, 12)
    elif blk.level == 2:
        payload.u(blk.target_max_pq, 12)
        payload.u(blk.trim_slope, 12)
        payload.u(blk.trim_offset, 12)
        payload.u(blk.trim_power, 12)
        payload.u(blk.trim_chroma_weight, 12)
        payload.u(blk.trim_saturation_gain, 12)
        payload.u(blk.ms_weight & 0x1FFF, 13)
    elif blk.level == 3:
        payload.u(blk.min_pq_offset, 12)
        payload.u(blk.max_pq_offset, 12)
        payload.u(blk.avg_pq_offset, 12)
    elif blk.level == 5:
        for v in blk.active_area:
            payload.u(v, 13)
    elif blk.level == 6:
        payload.u(blk.max_luminance, 16)
        payload.u(blk.min_luminance, 16)
        payload.u(blk.max_cll, 16)
        payload.u(blk.max_fall, 16)
    elif blk.level == 254:
        payload.u(blk.dm_mode, 8)
        payload.u(blk.dm_version_index, 8)
    data = payload.bytes()
    w.ue(len(data))
    w.u(blk.level, 8)
    for b in data:
        w.u(b, 8)


# ---------------------------------------------------------------------------
# Mapping to renderer metadata
# ---------------------------------------------------------------------------

def rpu_to_dovi(rpu: DoviRpu) -> DoviMetadata:
    """RPU -> DoviMetadata, scaled exactly like the reference's
    pl_map_dovi_metadata (libav_internal.h:896-945): pivots normalized
    by 2^bl_bit_depth - 1, coefficients by 2^-coef_log2_denom, the color
    matrices by their fixed denominators (8192 / 2^28 / 16384)."""
    pscale = 1.0 / ((1 << rpu.bl_bit_depth) - 1)
    cscale = 1.0 / (1 << rpu.coef_log2_denom)
    comp = []
    for cur in rpu.curves:
        poly = []
        mmr = []
        for i in range(cur.num_pivots - 1):
            if cur.mapping_idc[i] == 0:
                cs = [c * cscale for c in cur.poly_coef[i]]
                while len(cs) < 3:
                    cs.append(0.0)
                poly.append(tuple(cs))
                mmr.append(())
            else:
                poly.append((0.0, 0.0, 0.0))
                mmr.append(tuple(tuple(v * cscale for v in row)
                                 for row in cur.mmr_coef[i]))
        comp.append({
            "num_pivots": cur.num_pivots,
            "pivots": tuple(p * pscale for p in cur.pivots),
            "method": cur.mapping_idc,
            "poly_coeffs": tuple(poly),
            "mmr_order": cur.mmr_order,
            "mmr_constant": tuple(c * cscale for c in cur.mmr_constant),
            "mmr_coeffs": tuple(mmr),
        })
    return DoviMetadata(
        nonlinear_offset=tuple(v / (1 << 28)
                               for v in rpu.ycc_to_rgb_offset),
        nonlinear=tuple(
            tuple(rpu.ycc_to_rgb_matrix[r * 3 + c] / 8192.0
                  for c in range(3)) for r in range(3)),
        linear=tuple(
            tuple(rpu.rgb_to_lms_matrix[r * 3 + c] / 16384.0
                  for c in range(3)) for r in range(3)),
        comp=tuple(comp))


def hdr_metadata_from_rpu(hdr: HdrMetadata, buf: bytes) -> HdrMetadata:
    """Apply the RPU's L1 brightness metadata (reference
    pl_hdr_metadata_from_dovi_rpu, dolbyvision.c:26-63: max_pq_y/avg_pq_y
    = L1 values / 4095)."""
    try:
        rpu = parse_rpu(buf)
    except RpuError:
        return hdr
    if not rpu.dm_metadata_present:
        return hdr
    for blk in rpu.ext_blocks:
        if blk.level == 1:
            return replace(hdr, max_pq_y=blk.max_pq / 4095.0,
                           avg_pq_y=blk.avg_pq / 4095.0)
    return hdr
