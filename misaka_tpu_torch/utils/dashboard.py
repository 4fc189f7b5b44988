"""The dashboard: golden-signal sparklines over the embedded TSDB, served
as one self-contained HTML page at GET /debug/dashboard.

The port's copy of misaka_tpu/utils/dashboard.py (stdlib only): the same
``PANELS`` and page.  No external assets: the data is baked into the page
at render time and drawn as inline SVG by a little vanilla JS.  Panels:
throughput, p50/p99, error rate, admission sheds, queue depth,
native-pool busy fraction, replica health, canary success and latency,
per-program value rates and p99.  The native panels (pool busy fraction,
residency, dispenser wait and spin, SIMD width, specialized and JIT
engines, elided rows) read the native host tier's series
(core/native_serve.py) and render empty while no native engine serves.  In fleet mode the parent serves the same page over
its replica-merged series (each carries a ``replica`` label there), and
the page's label filters become the per-replica drill-down.

The page is built against a query function,
``query_fn(name, window_s) -> [{labels, points, ...}]``: the engine
passes utils/tsdb.query, the fleet parent its merging aggregator
(runtime/fleet.py).
"""

from __future__ import annotations

import json
import time

# (title, series name, aggregation hint for the JS, unit)
#   agg: how multiple matching series combine per time slot in the
#   headline line — "sum" (rates), "max" (latencies/depths), "min"
#   (success bits: any replica failing shows).
PANELS = (
    ("Throughput (values/s)", "misaka_compute_values_total", "sum", "/s"),
    ("HTTP p99", "misaka_http_request_duration_seconds:p99", "max", "s"),
    ("HTTP p50", "misaka_http_request_duration_seconds:p50", "max", "s"),
    ("HTTP errors (/s)", "misaka_http_errors_total", "sum", "/s"),
    ("Admission sheds (/s)", "misaka_edge_rejected_total", "sum", "/s"),
    ("Queue depth (waiting requests)", "misaka_serve_waiting_requests",
     "max", ""),
    ("Native pool busy fraction", "misaka_native_pool_busy_fraction",
     "max", ""),
    ("Residency hit ratio", "misaka_native_resident_hit_ratio",
     "max", ""),
    ("Pipelined plane frames (/s)", "misaka_plane_pipelined_frames_total",
     "sum", "/s"),
    ("Plane pipeline depth (max)", "misaka_plane_pipeline_depth_max",
     "max", ""),
    ("Dispenser wait p99", "misaka_native_dispenser_wait_seconds:p99",
     "max", "s"),
    ("Dispenser spin ratio", "misaka_native_dispenser_spin_ratio",
     "max", ""),
    ("SIMD lane width", "misaka_native_simd_lane_width", "max", ""),
    ("Specialized engines", "misaka_native_specialized_active", "max", ""),
    ("JIT engines", "misaka_native_jit_active", "max", ""),
    ("Elided pack rows (/s)", "misaka_native_elided_rows_total", "sum",
     "/s"),
    ("Plane shm frames (/s)", "misaka_plane_shm_frames_total", "sum", "/s"),
    ("Replicas alive", "misaka_fleet_replicas_alive", "min", ""),
    ("Canary success", "misaka_canary_success", "min", ""),
    ("Canary p99", "misaka_canary_latency_seconds:p99", "max", "s"),
    ("Per-program values/s", "misaka_usage_values_total", "sum", "/s"),
    ("Per-program SLO p99", "misaka_slo_p99_seconds", "max", "s"),
    ("TSDB spool on disk (bytes)", "misaka_tsdb_spool_bytes", "max", "B"),
    ("Spool drops (/s)", "misaka_tsdb_spool_dropped_total", "sum", "/s"),
    ("Capture spool on disk (bytes)", "misaka_capture_spool_bytes",
     "max", "B"),
    ("Spool errors (/s)", "misaka_spool_errors_total", "sum", "/s"),
)


def payload(query_fn, window_s: float, extra: dict | None = None) -> dict:
    """The baked DATA object: every panel's matching series over the
    window, plus canary/watchdog state when the caller passes it."""
    panels = []
    for title, name, agg, unit in PANELS:
        series = query_fn(name, window_s)
        panels.append({
            "title": title,
            "metric": name,
            "agg": agg,
            "unit": unit,
            "series": series,
        })
    out = {
        "generated_unix": round(time.time(), 3),
        "window_s": window_s,
        "panels": panels,
    }
    if extra:
        out.update(extra)
    return out


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>misaka observatory</title>
<style>
 body { font: 13px system-ui, sans-serif; margin: 16px; background: #fff;
        color: #222; }
 h1 { font-size: 16px; margin: 0 0 4px; }
 .meta { color: #555; margin-bottom: 10px; }
 .filters { margin-bottom: 12px; }
 .filters select { margin-right: 10px; }
 .grid { display: flex; flex-wrap: wrap; gap: 12px; }
 .panel { border: 1px solid #ddd; border-radius: 4px; padding: 8px;
          width: 320px; }
 .panel h2 { font-size: 12px; margin: 0 0 2px; font-weight: 600; }
 .panel .now { font-size: 18px; font-weight: 700; }
 .panel .range { color: #777; font-size: 11px; }
 .panel svg { display: block; margin-top: 4px; }
 .spark { stroke: #2a6fb0; stroke-width: 1.5; fill: none; }
 .sparkmax { stroke: #c0504d; stroke-width: 1; fill: none;
             stroke-dasharray: 2 2; }
 .empty { color: #999; font-size: 11px; margin-top: 8px; }
 .bad .now { color: #c0504d; }
 .alertbox { border: 1px solid #e4c0c0; background: #fdf4f4;
             border-radius: 4px; padding: 8px; margin-bottom: 12px;
             font-size: 12px; }
 .alertbox.ok { border-color: #cfe3cf; background: #f4faf4; }
</style></head><body>
<h1>misaka observatory</h1>
<div class="meta" id="meta"></div>
<div class="alertbox" id="alerts"></div>
<div class="filters">
  <label>program <select id="f_program"><option value="">all</option>
  </select></label>
  <label>replica <select id="f_replica"><option value="">all</option>
  </select></label>
</div>
<div class="grid" id="grid"></div>
<script>
const DATA = %s;
document.getElementById('meta').textContent =
  `window ${DATA.window_s}s | generated ` +
  new Date(DATA.generated_unix * 1000).toISOString();
// status strip: canary + watchdog state when the server baked them in
const alerts = document.getElementById('alerts');
{
  const bits = [];
  let bad = false;
  if (DATA.canary) {
    const c = DATA.canary;
    if (c.failing_tier) { bad = true;
      bits.push(`canary FAILING at tier "${c.failing_tier}" ` +
                `(${c.consecutive_full_failures} consecutive)`); }
    else bits.push('canary ok');
  }
  if (DATA.watchdog) {
    const firing = (DATA.watchdog.rules || [])
      .filter(r => r.state !== 'ok');
    if (firing.length) { bad = true;
      bits.push('watchdog: ' + firing.map(
        r => `${r.rule} ${r.state}`).join(', ')); }
    else bits.push('watchdog ok');
  }
  alerts.textContent = bits.join(' · ') || 'no canary/watchdog state';
  alerts.className = 'alertbox' + (bad ? '' : ' ok');
}
// label filters: every distinct program/replica value seen in any series
const labelValues = key => {
  const vals = new Set();
  for (const p of DATA.panels)
    for (const s of p.series)
      if (s.labels && s.labels[key] !== undefined) vals.add(s.labels[key]);
  return [...vals].sort();
};
for (const key of ['program', 'replica']) {
  const sel = document.getElementById('f_' + key);
  for (const v of labelValues(key)) {
    const o = document.createElement('option');
    o.value = v; o.textContent = v; sel.appendChild(o);
  }
  sel.onchange = render;
}
function fmt(v, unit) {
  if (v === null || v === undefined || !isFinite(v)) return '-';
  const a = Math.abs(v);
  let s;
  if (a >= 1e6) s = (v / 1e6).toFixed(2) + 'M';
  else if (a >= 1e3) s = (v / 1e3).toFixed(2) + 'k';
  else if (a >= 1 || a === 0) s = v.toFixed(2);
  else if (a >= 1e-3) s = (v * 1e3).toFixed(2) + 'm';
  else s = (v * 1e6).toFixed(1) + 'u';
  return s + unit;
}
function aggregate(series, agg) {
  // combine matching series per time slot: avg-line and max-line
  const slots = new Map();
  for (const s of series)
    for (const [t, avg, mx] of s.points) {
      let e = slots.get(t);
      if (!e) { e = {avg: null, max: null}; slots.set(t, e); }
      e.avg = e.avg === null ? avg :
        (agg === 'sum' ? e.avg + avg :
         agg === 'min' ? Math.min(e.avg, avg) : Math.max(e.avg, avg));
      e.max = e.max === null ? mx :
        (agg === 'sum' ? e.max + mx :
         agg === 'min' ? Math.min(e.max, mx) : Math.max(e.max, mx));
    }
  return [...slots.entries()].sort((x, y) => x[0] - y[0])
    .map(([t, e]) => [t, e.avg, e.max]);
}
function sparkline(points, w, h) {
  if (!points.length) return null;
  const ts = points.map(p => p[0]);
  const t0 = Math.min(...ts), t1 = Math.max(...ts);
  const vs = points.map(p => p[1]).concat(points.map(p => p[2]));
  let lo = Math.min(...vs), hi = Math.max(...vs);
  if (hi === lo) { hi = lo + 1; lo = lo - (lo === 0 ? 0 : 1e-9); }
  const x = t => t1 === t0 ? w / 2 : (t - t0) / (t1 - t0) * (w - 4) + 2;
  const y = v => h - 3 - (v - lo) / (hi - lo) * (h - 8);
  const line = i => points.map(
    p => `${x(p[0]).toFixed(1)},${y(p[i]).toFixed(1)}`).join(' ');
  return {avgLine: line(1), maxLine: line(2), lo, hi};
}
function render() {
  const fp = document.getElementById('f_program').value;
  const fr = document.getElementById('f_replica').value;
  const grid = document.getElementById('grid');
  grid.textContent = '';
  for (const p of DATA.panels) {
    const matching = p.series.filter(s => {
      const L = s.labels || {};
      if (fp && L.program !== undefined && L.program !== fp) return false;
      if (fp && p.metric.indexOf('usage') >= 0 &&
          L.program === undefined) return false;
      if (fr && L.replica !== undefined && L.replica !== fr) return false;
      return true;
    });
    const pts = aggregate(matching, p.agg);
    const div = document.createElement('div');
    div.className = 'panel';
    const h2 = document.createElement('h2');
    h2.textContent = p.title;
    div.appendChild(h2);
    if (!pts.length) {
      const e = document.createElement('div');
      e.className = 'empty';
      e.textContent = 'no data in window';
      div.appendChild(e);
      grid.appendChild(div);
      continue;
    }
    const last = pts[pts.length - 1];
    const now = document.createElement('span');
    now.className = 'now';
    now.textContent = fmt(last[1], p.unit);
    if (p.metric === 'misaka_canary_success' && last[1] < 1)
      div.classList.add('bad');
    div.appendChild(now);
    const sp = sparkline(pts, 300, 48);
    const range = document.createElement('div');
    range.className = 'range';
    range.textContent =
      `min ${fmt(sp.lo, p.unit)} · max ${fmt(sp.hi, p.unit)} · ` +
      `${pts.length} pts · ${matching.length} series`;
    div.appendChild(range);
    const svg = document.createElementNS(
      'http://www.w3.org/2000/svg', 'svg');
    svg.setAttribute('width', 300); svg.setAttribute('height', 48);
    for (const [cls, line] of
         [['sparkmax', sp.maxLine], ['spark', sp.avgLine]]) {
      const pl = document.createElementNS(
        'http://www.w3.org/2000/svg', 'polyline');
      pl.setAttribute('class', cls);
      pl.setAttribute('points', line);
      svg.appendChild(pl);
    }
    div.appendChild(svg);
    grid.appendChild(div);
  }
}
render();
</script></body></html>
"""


def render_html(query_fn, window_s: float, extra: dict | None = None) -> str:
    """The GET /debug/dashboard body (``?window=`` selects the span)."""
    return _PAGE % json.dumps(payload(query_fn, window_s, extra))
