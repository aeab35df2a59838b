"""Self-contained interactive HTML writers for the example scripts — the
framework-native analogue of the reference's GLMakie apps
(/root/reference/examples/rosenbrock.jl trajectory+slider viz,
adaptivekernel.jl parameter slider): a headless GPU machine has no GL display,
so the examples emit a single HTML file (data embedded as JSON, vanilla JS,
no network, no dependencies) that any browser opens."""

import json


def _page(title, body, script):
    return f"""<!doctype html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 1.5em; max-width: 860px; }}
 canvas {{ border: 1px solid #ccc; display: block; margin: .8em 0; }}
 .row {{ display: flex; gap: 1em; align-items: center; }}
 input[type=range] {{ flex: 1; }}
 .legend span {{ margin-right: 1.2em; font-size: .9em; }}
</style></head>
<body>
<h2>{title}</h2>
{body}
<script>
{script}
</script>
</body></html>
"""


def write_rosenbrock_html(path, grid, extent, paths, costs):
    """Interactive 4-optimizer trajectory viz (reference
    examples/rosenbrock.jl): log-cost heatmap, per-optimizer paths, an
    iteration slider that replays every optimizer in lockstep, and a
    per-optimizer cost readout.

    ``grid`` [ny, nx] of log10 cost, ``extent`` (x0, x1, y0, y1),
    ``paths`` {name: [[x, y], ...]} (element 0 = start),
    ``costs`` {name: [c0, c1, ...]}.
    """
    data = {
        "grid": [[round(float(v), 3) for v in row] for row in grid],
        "extent": list(map(float, extent)),
        "paths": {k: [[float(a), float(b)] for a, b in v] for k, v in paths.items()},
        "costs": {k: [float(c) for c in v] for k, v in costs.items()},
        "colors": {},
    }
    palette = ["#d62728", "#1f77b4", "#2ca02c", "#9467bd", "#ff7f0e"]
    for i, k in enumerate(paths):
        data["colors"][k] = palette[i % len(palette)]
    body = """
<div class="row"><label>iteration <b id="itlab">0</b></label>
 <input id="it" type="range" min="0" max="1" value="0" step="1">
 <button id="play">&#9654; play</button></div>
<canvas id="c" width="760" height="560"></canvas>
<div class="legend" id="legend"></div>
<div id="readout" style="font-family: monospace; white-space: pre;"></div>
"""
    script = "const D = " + json.dumps(data) + ";\n" + r"""
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const [x0, x1, y0, y1] = D.extent;
const names = Object.keys(D.paths);
const maxIt = Math.max(...names.map(n => D.paths[n].length - 1));
const sl = document.getElementById('it');
sl.max = maxIt;
function toPx(p) {
  return [ (p[0]-x0)/(x1-x0)*cv.width, cv.height - (p[1]-y0)/(y1-y0)*cv.height ];
}
// Heatmap from the embedded log-cost grid.
const ny = D.grid.length, nx = D.grid[0].length;
let lo = Infinity, hi = -Infinity;
for (const row of D.grid) for (const v of row) { lo = Math.min(lo, v); hi = Math.max(hi, v); }
const img = ctx.createImageData(nx, ny);
for (let j = 0; j < ny; j++) for (let i = 0; i < nx; i++) {
  const t = (D.grid[j][i] - lo) / (hi - lo);
  const k = 4 * ((ny - 1 - j) * nx + i);   // grid row 0 = y0 (bottom)
  img.data[k]   = 30 + 225 * t;
  img.data[k+1] = 40 + 160 * (1 - Math.abs(t - .5) * 2);
  img.data[k+2] = 90 + 160 * (1 - t);
  img.data[k+3] = 255;
}
const off = document.createElement('canvas');
off.width = nx; off.height = ny;
off.getContext('2d').putImageData(img, 0, 0);
const legend = document.getElementById('legend');
legend.innerHTML = names.map(n =>
  `<span style="color:${D.colors[n]}">&#9632; ${n}</span>`).join('');
function draw(it) {
  ctx.imageSmoothingEnabled = true;
  ctx.drawImage(off, 0, 0, cv.width, cv.height);
  let txt = '';
  for (const n of names) {
    const p = D.paths[n], m = Math.min(it, p.length - 1);
    ctx.strokeStyle = D.colors[n]; ctx.lineWidth = 2; ctx.beginPath();
    for (let i = 0; i <= m; i++) {
      const [px, py] = toPx(p[i]);
      if (i === 0) ctx.moveTo(px, py); else ctx.lineTo(px, py);
    }
    ctx.stroke();
    const [px, py] = toPx(p[m]);
    ctx.fillStyle = D.colors[n];
    ctx.beginPath(); ctx.arc(px, py, 4, 0, 7); ctx.fill();
    const c = D.costs[n][Math.min(m, D.costs[n].length - 1)];
    txt += n.padEnd(22) + ' iter ' + String(m).padStart(3)
         + '  cost ' + c.toExponential(3) + '\n';
  }
  document.getElementById('readout').textContent = txt;
  document.getElementById('itlab').textContent = it;
}
sl.oninput = () => draw(+sl.value);
let timer = null;
document.getElementById('play').onclick = () => {
  if (timer) { clearInterval(timer); timer = null; return; }
  timer = setInterval(() => {
    sl.value = (+sl.value + 1) % (maxIt + 1); draw(+sl.value);
  }, 180);
};
draw(0);
"""
    with open(path, "w") as f:
        f.write(_page("nllstpu — Rosenbrock, four optimizers", body, script))


def write_adaptive_html(path, data_points, frames, rho_x, labels):
    """Interactive adaptive-kernel viz (reference examples/adaptivekernel.jl
    slider app): data histogram + fitted mixture density and the robust
    loss ρ, with a slider interpolating the kernel parameters from the
    initial guess to the converged fit.

    ``frames``: list of dicts {"sw": [s1, s2, w], "mean": m,
    "density": [...], "rho": [...]} sampled along the fit;
    ``rho_x``: abscissa for the density/rho curves; ``labels``: per-frame
    slider captions."""
    payload = {
        "hist": [float(v) for v in data_points],
        "frames": frames,
        "x": [float(v) for v in rho_x],
        "labels": labels,
    }
    body = """
<div class="row"><label id="cap" style="min-width: 22em"></label>
 <input id="f" type="range" min="0" max="1" value="0" step="1"></div>
<canvas id="dens" width="760" height="320"></canvas>
<canvas id="rho" width="760" height="220"></canvas>
"""
    script = "const D = " + json.dumps(payload) + ";\n" + r"""
const sl = document.getElementById('f');
sl.max = D.frames.length - 1;
const x = D.x, xmin = x[0], xmax = x[x.length-1];
// Histogram bins.
const nb = 60, bins = new Array(nb).fill(0);
for (const v of D.hist) {
  const b = Math.floor((v - xmin) / (xmax - xmin) * nb);
  if (b >= 0 && b < nb) bins[b]++;
}
const binw = (xmax - xmin) / nb;
const histMax = Math.max(...bins) / (D.hist.length * binw);
function drawCurve(cv, ys, ymax, color, clear) {
  const ctx = cv.getContext('2d');
  if (clear) ctx.clearRect(0, 0, cv.width, cv.height);
  ctx.strokeStyle = color; ctx.lineWidth = 2; ctx.beginPath();
  for (let i = 0; i < x.length; i++) {
    const px = (x[i]-xmin)/(xmax-xmin)*cv.width;
    const py = cv.height - Math.min(ys[i]/ymax, 1) * (cv.height - 10);
    if (i === 0) ctx.moveTo(px, py); else ctx.lineTo(px, py);
  }
  ctx.stroke();
}
function draw(fi) {
  const fr = D.frames[fi];
  const cv = document.getElementById('dens'), ctx = cv.getContext('2d');
  ctx.clearRect(0, 0, cv.width, cv.height);
  ctx.fillStyle = '#bbb';
  const densMax = Math.max(histMax, ...fr.density) * 1.05;
  for (let b = 0; b < nb; b++) {
    const h = bins[b] / (D.hist.length * binw) / densMax * (cv.height - 10);
    ctx.fillRect(b / nb * cv.width, cv.height - h, cv.width / nb - 1, h);
  }
  drawCurve(cv, fr.density, densMax, '#d62728', false);
  const rcv = document.getElementById('rho');
  drawCurve(rcv, fr.rho, Math.max(...fr.rho) * 1.05, '#1f77b4', true);
  document.getElementById('cap').textContent = D.labels[fi];
}
sl.oninput = () => draw(+sl.value);
draw(0);
"""
    with open(path, "w") as f:
        f.write(
            _page("nllstpu — adaptive ContaminatedGaussian fit", body, script)
        )
