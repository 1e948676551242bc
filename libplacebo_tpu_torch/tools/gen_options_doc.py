#!/usr/bin/env python3
"""Write the port's option table as Markdown (the analog of the
reference's docs/options.md, which hand-documents options.c's table).

The layout, the groups and every row are the JAX package's
docs/options.md generator's (tools/gen_options_doc.py), so the port's
output equals that committed file line for line but the one that names
the package to import: the two option tables are pinned together.  The
output goes to stdout, or to --out; the committed docs/options.md
documents the JAX package and is never written here.

Usage: python3 -m libplacebo_tpu_torch.tools.gen_options_doc [--out FILE]
"""
import argparse
import os
import sys

def _fmt_range(o) -> str:
    if o.type not in ("int", "float") or (o.minimum == 0.0
                                          and o.maximum == 0.0):
        return ""
    lo = o.minimum
    hi = o.maximum
    if o.type == "int":
        return f"{int(lo)} … {int(hi)}"
    return f"{lo:g} … {hi:g}"


_EXACT_GROUPS = {
    # tone-mapping operator constants (ToneMapConstants)
    "knee_adaptation": "Color mapping", "knee_minimum": "Color mapping",
    "knee_maximum": "Color mapping", "knee_default": "Color mapping",
    "knee_offset": "Color mapping", "slope_tuning": "Color mapping",
    "slope_offset": "Color mapping", "spline_contrast": "Color mapping",
    "reinhard_contrast": "Color mapping", "linear_knee": "Color mapping",
    "exposure": "Color mapping",
    # gamut-mapping operator constants (GamutMapConstants)
    "perceptual_deadzone": "Color mapping",
    "perceptual_strength": "Color mapping",
    "colorimetric_gamma": "Color mapping",
    "softclip_knee": "Color mapping", "softclip_desat": "Color mapping",
    # peak-detection sub-params
    "peak_smoothing_period": "HDR peak detection",
    "peak_percentile": "HDR peak detection",
    "scene_threshold_low": "HDR peak detection",
    "scene_threshold_high": "HDR peak detection",
    "black_cutoff": "HDR peak detection",
    "minimum_peak": "HDR peak detection",
    "visualize_hue": "Color mapping", "visualize_theta": "Color mapping",
    "tile_color_hi_r": "Output", "tile_color_hi_g": "Output",
    "tile_color_hi_b": "Output", "tile_color_lo_r": "Output",
    "tile_color_lo_g": "Output", "tile_color_lo_b": "Output",
    "tile_size": "Output",
    "linear_scaling": "Scaling", "force_dither": "Dithering",
    "ignore_icc_profiles": "ICC",
    "polar_cutoff": "Performance / debugging",
    "force_low_bit_depth_fbos": "Performance / debugging",
    "dynamic_constants": "Performance / debugging",
}


def _group(key: str) -> str:
    if key in _EXACT_GROUPS:
        return _EXACT_GROUPS[key]
    for prefix, title in (
            ("upscaler", "Scaling"), ("downscaler", "Scaling"),
            ("plane_", "Scaling"), ("frame_mixer", "Frame mixing"),
            ("antiringing", "Scaling"), ("correct_subpixel", "Scaling"),
            ("deband", "Debanding"), ("sigmoid", "Scaling"),
            ("color_adjustment", "Color adjustment"),
            ("brightness", "Color adjustment"),
            ("contrast", "Color adjustment"),
            ("saturation", "Color adjustment"),
            ("gamma", "Color adjustment"), ("hue", "Color adjustment"),
            ("temperature", "Color adjustment"),
            ("cone", "Cone distortion"),
            ("peak_detect", "HDR peak detection"),
            ("color_map", "Color mapping"),
            ("tone_", "Color mapping"), ("gamut_", "Color mapping"),
            ("inverse_tone", "Color mapping"),
            ("contrast_recovery", "Color mapping"),
            ("contrast_smoothness", "Color mapping"),
            ("show_clipping", "Color mapping"),
            ("visualize_lut", "Color mapping"),
            ("force_tone_mapping_lut", "Color mapping"),
            ("dither", "Dithering"), ("error_diffusion", "Dithering"),
            ("grain", "Film grain"), ("film_grain", "Film grain"),
            ("deinterlace", "Deinterlacing"),
            ("distort", "Distortion"),
            ("icc", "ICC"),
            ("lut", "Custom LUTs"),
            ("hook", "Custom shaders"),
            ("blend", "Output blending"),
            ("background", "Output"), ("border", "Output"),
            ("blur", "Output"), ("corner_round", "Output"),
            ("skip_", "Performance / debugging"),
            ("disable_", "Performance / debugging"),
            ("allow_delayed", "HDR peak detection"),
            ("preserve_mixing", "Frame mixing"),
            ("preset", "Presets"),
    ):
        if key.startswith(prefix):
            return title
    return "Miscellaneous"


def generate() -> str:
    from ..core.options import OPTION_TABLE

    groups = {}
    order = []
    for o in OPTION_TABLE():
        g = _group(o.key)
        if g not in groups:
            groups[g] = []
            order.append(g)
        groups[g].append(o)

    lines = [
        "# Options",
        "",
        "Every render parameter reachable by string through the",
        "`Options` class (the `pl_options` surface; reference",
        "options.c:908-963 and docs/options.md). This file is",
        "GENERATED by `tools/gen_options_doc.py` — do not edit.",
        "",
        "```python",
        "from libplacebo_tpu_torch import Options",
        "opts = Options()",
        'opts.parse("preset=high_quality,deband=yes,'
        'tone_mapping=bt.2390")',
        "params = opts.params          # RenderParams for the Renderer",
        'print(opts.save())            # non-default options, roundtrips',
        "```",
        "",
        "Booleans accept yes/no/on/off/true/false/1/0. Enum options",
        "reject unknown values with an `OptionError` listing the",
        "choices. Out-of-range numbers are clamped (with a log",
        "warning), mirroring the reference's bounds behavior.",
        "",
    ]
    total = 0
    for g in order:
        lines.append(f"## {g}")
        lines.append("")
        lines.append("| key | type | range / choices | description |")
        lines.append("|---|---|---|---|")
        for o in groups[g]:
            total += 1
            rng = _fmt_range(o)
            if o.choices:
                rng = ", ".join(f"`{c}`" for c in o.choices)
            desc = (o.description or "").replace("|", "\\|")
            lines.append(f"| `{o.key}` | {o.type} | {rng} | {desc} |")
        lines.append("")
    lines.append(f"*{total} options total.*")
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gen_options_doc")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="write here instead of stdout")
    args = ap.parse_args(argv)
    text = generate()
    if args.out is None:
        sys.stdout.write(text)
        return 0
    committed = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "docs", "options.md")
    if os.path.realpath(args.out) == os.path.realpath(committed):
        raise SystemExit("docs/options.md documents the JAX package; "
                         "write the port's table elsewhere")
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out} ({len(text.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
