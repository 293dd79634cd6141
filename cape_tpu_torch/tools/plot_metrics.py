"""Training-curve dashboard from a run's metrics.jsonl.

Counterpart of `cape_tpu.tools.plot_metrics` (copied; json and html only),
so that both packages draw the same page from the same records. The
reference watched training through TensorBoard scalar summaries
(reference lib/models.py:400-414, 918-922: per-loss scalars + EMA
curves). This is one self-contained HTML file (inline SVG, no
dependencies) with a line chart per metric, EMA overlays where logged,
per-epoch validation markers, and a final-values table.

Usage:
    python -m cape_tpu_torch.tools.plot_metrics results/<run_name> [-o out.html]
    python -m cape_tpu_torch.tools.plot_metrics path/to/metrics.jsonl

Reads the append-only JSONL written by train.metrics.MetricsLogger: one
record per logged train step ({"step", "t", <losses>}) and one richer
record per epoch ({... "val_*", "epoch", "lr_g", "step_ms"}).
"""

from __future__ import annotations

import argparse
import html
import json
import os
from collections import defaultdict

# chart geometry (SVG user units)
W, H = 560, 240
PAD_L, PAD_R, PAD_T, PAD_B = 58, 14, 24, 32

# metric -> overlay metric drawn on the same axes (EMA pairs)
OVERLAYS = {"loss_g": "loss_g_ema", "loss_d": "loss_d_ema"}
# keys that are chart axes metadata, not metrics
META_KEYS = {"step", "t", "epoch"}


def read_metrics(path: str) -> list[dict]:
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # tolerate a torn tail line from a live run
    return records


def _series(records: list[dict]) -> dict[str, list[tuple[float, float]]]:
    out: dict[str, list[tuple[float, float]]] = defaultdict(list)
    for r in records:
        step = r.get("step")
        if step is None:
            continue
        for k, v in r.items():
            if k in META_KEYS or not isinstance(v, (int, float)):
                continue
            out[k].append((float(step), float(v)))
    return dict(out)


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    a = abs(v)
    if a >= 1000 or a < 1e-3:
        return f"{v:.2e}"
    return f"{v:.4g}"


def _polyline(pts, x0, x1, y0, y1, color, width=1.5, dash=""):
    """Map data points into the chart viewport and emit an SVG polyline."""
    sx = (W - PAD_L - PAD_R) / max(x1 - x0, 1e-12)
    sy = (H - PAD_T - PAD_B) / max(y1 - y0, 1e-12)
    coords = " ".join(
        f"{PAD_L + (x - x0) * sx:.1f},{H - PAD_B - (y - y0) * sy:.1f}"
        for x, y in pts
    )
    dash_attr = f' stroke-dasharray="{dash}"' if dash else ""
    return (
        f'<polyline fill="none" stroke="{color}" stroke-width="{width}"'
        f'{dash_attr} points="{coords}"/>'
    )


def _chart(name: str, pts, overlay_name=None, overlay_pts=None) -> str:
    xs = [p[0] for p in pts] + [p[0] for p in (overlay_pts or [])]
    ys = [p[1] for p in pts] + [p[1] for p in (overlay_pts or [])]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if y0 == y1:
        y0, y1 = y0 - 0.5, y1 + 0.5
    # y-axis ticks at min / mid / max, x ticks at start / end
    ticks = []
    for frac in (0.0, 0.5, 1.0):
        yv = y0 + frac * (y1 - y0)
        ypix = H - PAD_B - frac * (H - PAD_T - PAD_B)
        ticks.append(
            f'<line x1="{PAD_L}" y1="{ypix:.1f}" x2="{W - PAD_R}" y2="{ypix:.1f}"'
            f' stroke="#e3e3e8" stroke-width="1"/>'
            f'<text x="{PAD_L - 6}" y="{ypix + 4:.1f}" text-anchor="end"'
            f' class="tick">{_fmt(yv)}</text>'
        )
    for frac, anchor in ((0.0, "start"), (1.0, "end")):
        xv = x0 + frac * (x1 - x0)
        xpix = PAD_L + frac * (W - PAD_L - PAD_R)
        ticks.append(
            f'<text x="{xpix:.1f}" y="{H - 8}" text-anchor="{anchor}"'
            f' class="tick">step {int(xv)}</text>'
        )
    body = _polyline(pts, x0, x1, y0, y1, "#3b5bdb")
    legend = ""
    if overlay_pts:
        body += _polyline(overlay_pts, x0, x1, y0, y1, "#e8590c", dash="5,3")
        legend = (
            f'<text x="{W - PAD_R}" y="{PAD_T - 8}" text-anchor="end" class="tick">'
            f'<tspan fill="#3b5bdb">{html.escape(name)}</tspan>'
            f' <tspan fill="#e8590c">{html.escape(overlay_name)}</tspan></text>'
        )
    last = pts[-1][1]
    return (
        f'<div class="card"><h3>{html.escape(name)}'
        f'<span class="final">final {_fmt(last)}</span></h3>'
        f'<svg viewBox="0 0 {W} {H}" role="img"'
        f' aria-label="{html.escape(name)} vs step">{"".join(ticks)}{body}{legend}</svg></div>'
    )


def render_html(records: list[dict], title: str) -> str:
    series = _series(records)
    overlaid = set(OVERLAYS.values())
    # stable, reader-friendly order: train losses, then val_*, then rest
    def order(k):
        return (k.startswith("val_"), not k.startswith("loss"), k)

    charts = []
    for k in sorted((k for k in series if k not in overlaid), key=order):
        ov = OVERLAYS.get(k)
        charts.append(
            _chart(k, series[k], ov, series.get(ov) if ov else None)
        )
    final_rows = "".join(
        f"<tr><td>{html.escape(k)}</td><td>{_fmt(series[k][-1][1])}</td></tr>"
        for k in sorted(series, key=order)
    )
    n_steps = int(max((r.get("step", 0) for r in records), default=0))
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{html.escape(title)}</title>
<style>
 body {{ font: 14px system-ui, sans-serif; margin: 24px; color: #1a1b1e; }}
 h1 {{ font-size: 20px; }} h3 {{ margin: 0 0 4px; font-size: 14px; }}
 .final {{ float: right; color: #868e96; font-weight: normal; }}
 .grid {{ display: grid; grid-template-columns: repeat(auto-fill, minmax(420px, 1fr)); gap: 18px; }}
 .card {{ border: 1px solid #dee2e6; border-radius: 8px; padding: 10px 12px; }}
 svg {{ width: 100%; height: auto; }} .tick {{ font-size: 10px; fill: #868e96; }}
 table {{ border-collapse: collapse; margin-top: 18px; }}
 td {{ border: 1px solid #dee2e6; padding: 3px 10px; }}
</style></head><body>
<h1>{html.escape(title)} <span class="final">{len(records)} records, {n_steps} steps</span></h1>
<div class="grid">{"".join(charts)}</div>
<h3 style="margin-top:22px">Final values</h3>
<table>{final_rows}</table>
</body></html>"""


def plot_metrics(path: str, out: str | None = None) -> str:
    """path: a run dir containing metrics.jsonl, or the .jsonl itself.
    Writes the HTML dashboard next to the metrics file; returns out path."""
    if os.path.isdir(path):
        jsonl = os.path.join(path, "metrics.jsonl")
        title = os.path.basename(os.path.normpath(path))
    else:
        jsonl = path
        title = os.path.basename(os.path.dirname(os.path.abspath(path))) or jsonl
    records = read_metrics(jsonl)
    if not records:
        # ValueError (not SystemExit): callers like Trainer.fit guard with
        # `except Exception`, which SystemExit would slip past.
        raise ValueError(f"no metric records in {jsonl}")
    out = out or os.path.join(os.path.dirname(os.path.abspath(jsonl)), "metrics.html")
    with open(out, "w") as fh:
        fh.write(render_html(records, title))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path", help="run dir (containing metrics.jsonl) or a metrics.jsonl")
    p.add_argument("-o", "--out", default=None, help="output HTML path")
    a = p.parse_args(argv)
    try:
        out = plot_metrics(a.path, a.out)
    except ValueError as e:
        raise SystemExit(str(e))
    print(out)


if __name__ == "__main__":
    main()
