"""Interactive mesh viewer — a single self-contained HTML file.

A copy of `cape_tpu.meshops.viewer` (numpy only): for the same inputs both
give the same bytes, the default titles included.

Replaces the *interactive* half of the reference's psbody MeshViewers
(reference demos.py:225-246, lib/load_data.py:134-141): an OpenGL window
grid needs a display, which accelerator hosts and CI runners don't have. Instead
each demo batch is exported as one HTML file with the mesh data embedded
(base64 Float32/Uint16) and a dependency-free WebGL renderer inline —
open it in any browser, locally or out of CI artifacts, and orbit/zoom
the generated bodies. No network access, no three.js, no install.

Controls: drag = orbit, wheel = zoom, shift-drag = pan, buttons or
arrow keys = switch sample, space = cycle samples.

The static contact sheets (meshops.render) stay the quick-look surface;
this is the "rotate it and look" surface.
"""

from __future__ import annotations

import base64
import html
import json
import os

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>__TITLE__</title>
<style>
  body { margin: 0; background: #16181d; color: #d7dae0; font: 13px system-ui, sans-serif; overflow: hidden; }
  #bar { position: fixed; top: 0; left: 0; right: 0; padding: 8px 12px; display: flex; gap: 6px; align-items: center; flex-wrap: wrap; background: rgba(22,24,29,.85); }
  #bar b { margin-right: 10px; font-weight: 600; }
  button { background: #2a2e37; color: #d7dae0; border: 1px solid #3a3f4b; border-radius: 4px; padding: 3px 10px; cursor: pointer; font: inherit; }
  button.on { background: #4a6cd4; border-color: #4a6cd4; color: #fff; }
  #hint { position: fixed; bottom: 8px; left: 12px; color: #8a8f99; }
  canvas { display: block; }
</style>
</head>
<body>
<div id="bar"><b>__TITLE__</b></div>
<div id="hint">drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan &nbsp; &larr;/&rarr;: sample &nbsp; space: cycle</div>
<canvas id="c"></canvas>
<script>
"use strict";
const NAMES = __NAMES__;
const NV = __NV__, NF = __NF__;
const VB64 = __VERTS__;      // per-mesh base64 little-endian float32 [NV*3]
const FB64 = "__FACES__";    // base64 little-endian uint32 [NF*3]

function b64ToF32(s) { const b = atob(s), a = new Uint8Array(b.length); for (let i = 0; i < b.length; i++) a[i] = b.charCodeAt(i); return new Float32Array(a.buffer); }
function b64ToU32(s) { const b = atob(s), a = new Uint8Array(b.length); for (let i = 0; i < b.length; i++) a[i] = b.charCodeAt(i); return new Uint32Array(a.buffer); }

const faces = b64ToU32(FB64);
const meshes = VB64.map(b64ToF32);

// flat-shaded geometry: expand to per-face vertices so each triangle has
// its own normal (cloth wrinkles read better than smooth shading)
function expand(verts) {
  const pos = new Float32Array(NF * 9), nrm = new Float32Array(NF * 9);
  for (let f = 0; f < NF; f++) {
    const i0 = faces[3*f], i1 = faces[3*f+1], i2 = faces[3*f+2];
    const ax = verts[3*i0], ay = verts[3*i0+1], az = verts[3*i0+2];
    const bx = verts[3*i1], by = verts[3*i1+1], bz = verts[3*i1+2];
    const cx = verts[3*i2], cy = verts[3*i2+1], cz = verts[3*i2+2];
    let nx = (by-ay)*(cz-az)-(bz-az)*(cy-ay),
        ny = (bz-az)*(cx-ax)-(bx-ax)*(cz-az),
        nz = (bx-ax)*(cy-ay)-(by-ay)*(cx-ax);
    const l = Math.hypot(nx, ny, nz) || 1; nx /= l; ny /= l; nz /= l;
    const o = 9*f;
    pos.set([ax,ay,az,bx,by,bz,cx,cy,cz], o);
    nrm.set([nx,ny,nz,nx,ny,nz,nx,ny,nz], o);
  }
  return {pos, nrm};
}

const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl", {antialias: true});
const VS = `attribute vec3 p; attribute vec3 n; uniform mat4 mvp; uniform mat3 rot;
varying vec3 vn; void main() { gl_Position = mvp * vec4(p, 1.0); vn = rot * n; }`;
const FS = `precision mediump float; varying vec3 vn;
void main() {
  vec3 n = normalize(vn);
  float d = abs(dot(n, normalize(vec3(0.25, 0.35, 0.9))));
  float d2 = abs(dot(n, normalize(vec3(-0.6, 0.1, -0.4))));
  vec3 base = vec3(0.80, 0.81, 0.84);
  gl_FragColor = vec4(base * (0.22 + 0.62 * d + 0.16 * d2), 1.0);
}`;
function shader(type, src) { const s = gl.createShader(type); gl.shaderSource(s, src); gl.compileShader(s); if (!gl.getShaderParameter(s, gl.COMPILE_STATUS)) throw gl.getShaderInfoLog(s); return s; }
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const locP = gl.getAttribLocation(prog, "p"), locN = gl.getAttribLocation(prog, "n");
const locMVP = gl.getUniformLocation(prog, "mvp"), locROT = gl.getUniformLocation(prog, "rot");
const bufP = gl.createBuffer(), bufN = gl.createBuffer();
gl.enableVertexAttribArray(locP); gl.enableVertexAttribArray(locN);
gl.enable(gl.DEPTH_TEST);

// scene framing from mesh 0
let center = [0, 0, 0], radius = 1;
(function frame() {
  const v = meshes[0]; const lo = [1e9,1e9,1e9], hi = [-1e9,-1e9,-1e9];
  for (let i = 0; i < NV; i++) for (let k = 0; k < 3; k++) {
    const x = v[3*i+k]; if (x < lo[k]) lo[k] = x; if (x > hi[k]) hi[k] = x;
  }
  for (let k = 0; k < 3; k++) center[k] = (lo[k] + hi[k]) / 2;
  radius = Math.max(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2]) * 0.62;
})();

let cur = -1, yaw = 0.45, pitch = 0.08, dist = 3.2, panX = 0, panY = 0;
function setMesh(i) {
  cur = i;
  const g = expand(meshes[i]);
  gl.bindBuffer(gl.ARRAY_BUFFER, bufP); gl.bufferData(gl.ARRAY_BUFFER, g.pos, gl.STATIC_DRAW);
  gl.bindBuffer(gl.ARRAY_BUFFER, bufN); gl.bufferData(gl.ARRAY_BUFFER, g.nrm, gl.STATIC_DRAW);
  document.querySelectorAll("#bar button.s").forEach((b, j) => b.classList.toggle("on", j === i));
  draw();
}

function matMul(a, b) { const o = new Float32Array(16);
  for (let r = 0; r < 4; r++) for (let c = 0; c < 4; c++) { let s = 0;
    for (let k = 0; k < 4; k++) s += a[4*k+r] * b[4*c+k]; o[4*c+r] = s; } return o; }

function draw() {
  if (cur < 0) return;
  const w = canvas.clientWidth, h = canvas.clientHeight;
  gl.viewport(0, 0, canvas.width, canvas.height);
  gl.clearColor(0.086, 0.094, 0.113, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  const cy = Math.cos(yaw), sy = Math.sin(yaw), cp = Math.cos(pitch), sp = Math.sin(pitch);
  // rot = Rx(pitch) * Ry(yaw), column-major 3x3
  const rot3 = [cy, sp*sy, -cp*sy,  0, cp, sp,  sy, -sp*cy, cp*cy];
  const R = [rot3[0],rot3[1],rot3[2],0, rot3[3],rot3[4],rot3[5],0, rot3[6],rot3[7],rot3[8],0, 0,0,0,1];
  const T = [1,0,0,0, 0,1,0,0, 0,0,1,0, -center[0],-center[1],-center[2],1];
  const eye = [1,0,0,0, 0,1,0,0, 0,0,1,0, panX, panY, -dist*radius, 1];
  const f = 2.4, asp = w / h, near = 0.01 * radius, far = 100 * radius;
  const P = [f/asp,0,0,0, 0,f,0,0, 0,0,(far+near)/(near-far),-1, 0,0,2*far*near/(near-far),0];
  gl.uniformMatrix4fv(locMVP, false, matMul(P, matMul(eye, matMul(R, T))));
  gl.uniformMatrix3fv(locROT, false, rot3);
  gl.bindBuffer(gl.ARRAY_BUFFER, bufP); gl.vertexAttribPointer(locP, 3, gl.FLOAT, false, 0, 0);
  gl.bindBuffer(gl.ARRAY_BUFFER, bufN); gl.vertexAttribPointer(locN, 3, gl.FLOAT, false, 0, 0);
  gl.drawArrays(gl.TRIANGLES, 0, NF * 3);
}

function resize() {
  const dpr = window.devicePixelRatio || 1;
  canvas.style.width = window.innerWidth + "px"; canvas.style.height = window.innerHeight + "px";
  canvas.width = window.innerWidth * dpr; canvas.height = window.innerHeight * dpr;
  draw();
}
window.addEventListener("resize", resize);

let drag = null;
canvas.addEventListener("mousedown", e => { drag = {x: e.clientX, y: e.clientY, pan: e.shiftKey}; });
window.addEventListener("mouseup", () => { drag = null; });
window.addEventListener("mousemove", e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan) { panX += dx * 0.002 * radius * dist; panY -= dy * 0.002 * radius * dist; }
  else { yaw += dx * 0.008; pitch = Math.max(-1.5, Math.min(1.5, pitch + dy * 0.008)); }
  draw();
});
canvas.addEventListener("wheel", e => { e.preventDefault(); dist *= Math.exp(e.deltaY * 0.001); dist = Math.max(0.3, Math.min(30, dist)); draw(); }, {passive: false});

let playing = false, timer = null;
window.addEventListener("keydown", e => {
  if (e.key === "ArrowRight") setMesh((cur + 1) % meshes.length);
  else if (e.key === "ArrowLeft") setMesh((cur + meshes.length - 1) % meshes.length);
  else if (e.key === " ") { e.preventDefault(); togglePlay(); }
});
function togglePlay() {
  playing = !playing;
  document.getElementById("play").classList.toggle("on", playing);
  if (playing) timer = setInterval(() => setMesh((cur + 1) % meshes.length), 900);
  else clearInterval(timer);
}

const bar = document.getElementById("bar");
NAMES.forEach((name, i) => {
  const b = document.createElement("button");
  b.textContent = name; b.className = "s";
  b.onclick = () => setMesh(i);
  bar.appendChild(b);
});
if (meshes.length > 1) {
  const b = document.createElement("button");
  b.textContent = "\\u25b6 cycle"; b.id = "play"; b.onclick = togglePlay;
  bar.appendChild(b);
} else {
  const span = document.createElement("span"); span.id = "play"; bar.appendChild(span);
}
resize();
setMesh(0);
</script>
__LIVE__
</body>
</html>
"""

# Injected in place of __LIVE__ by live_viewer_html (apps/server.py GET
# /viewer): controls that POST the server's own /sample endpoint and
# render the returned displacements on top of the embedded template mesh.
# This is the live counterpart of the reference's interactive MeshViewers
# window (reference demos.py:225-246) for headless hosts: the browser
# is the display, the model server is the render source.
_LIVE_SCRIPT = """<script>
"use strict";
const MEAN = __MEAN__ ? b64ToF32(__MEAN__) : null;   // [NV*3] train stats
const STD  = __STD__ ? b64ToF32(__STD__) : null;
const POSES = __POSES__;        // rows of cond_dim floats (demo poses)
const CLO_DIM = __CLODIM__, HAS_GMM = __HASGMM__;
const TPL = meshes[0];          // absolute template vertices

const ctl = document.createElement("div");
ctl.id = "live";
ctl.style.cssText = "position:fixed;top:40px;left:0;right:0;padding:6px 12px;display:flex;gap:6px;align-items:center;flex-wrap:wrap;background:rgba(22,24,29,.85)";
function sel(opts, id) {
  const s = document.createElement("select");
  s.id = id;
  s.style.cssText = "background:#2a2e37;color:#d7dae0;border:1px solid #3a3f4b;border-radius:4px;padding:2px 6px;font:inherit";
  opts.forEach(([v, label]) => { const o = document.createElement("option"); o.value = v; o.textContent = label; s.appendChild(o); });
  return s;
}
function num(id, v, lo, hi) {
  const i = document.createElement("input");
  i.type = "number"; i.id = id; i.value = v; i.min = lo; i.max = hi;
  i.style.cssText = "width:64px;background:#2a2e37;color:#d7dae0;border:1px solid #3a3f4b;border-radius:4px;padding:2px 6px;font:inherit";
  return i;
}
function label(t) { const s = document.createElement("span"); s.textContent = t; s.style.color = "#8a8f99"; return s; }
const poseSel = sel(POSES.map((_, i) => [i, "pose " + i]), "pose");
const cloSel = sel(Array.from({length: CLO_DIM}, (_, i) => [i, "clotype " + i]), "clo");
const priors = [["normal", "N(0,1) prior"]]; if (HAS_GMM) priors.push(["gmm", "GMM prior"]);
const priorSel = sel(priors, "prior");
const seedIn = num("seed", 0, 0, 999999);
const nIn = num("nsamples", 4, 1, 16);
const go = document.createElement("button");
go.id = "generate"; go.textContent = "generate";
const status = document.createElement("span");
status.id = "status"; status.style.color = "#8a8f99";
[label("condition:"), poseSel, cloSel, label("prior:"), priorSel,
 label("seed:"), seedIn, label("n:"), nIn, go, status].forEach(e => ctl.appendChild(e));
document.body.appendChild(ctl);

function addSampleButton(name, idx) {
  const b = document.createElement("button");
  b.textContent = name; b.className = "s";
  b.onclick = () => setMesh(idx);
  document.getElementById("bar").appendChild(b);
}
async function generate() {
  go.disabled = true;
  status.textContent = "sampling\\u2026";
  try {
    const pose = [POSES[+poseSel.value]];
    const clo = [Array.from({length: CLO_DIM}, (_, i) => i === +cloSel.value ? 1 : 0)];
    const body = {n: +nIn.value, seed: +seedIn.value, prior: priorSel.value, pose: pose, clo: clo};
    const r = await fetch("/sample", {method: "POST", headers: {"Content-Type": "application/json"}, body: JSON.stringify(body)});
    const j = await r.json();
    if (j.error) { status.textContent = "error: " + j.error; return; }
    meshes.length = 1; NAMES.length = 1;
    document.querySelectorAll("#bar button.s").forEach((b, i) => { if (i > 0) b.remove(); });
    j.disp.forEach((d, i) => {
      const v = new Float32Array(NV * 3);
      for (let k = 0; k < NV; k++) for (let c = 0; c < 3; c++) {
        const o = 3 * k + c;
        let disp = d[k][c];
        if (STD) disp = disp * STD[o] + MEAN[o];
        v[o] = TPL[o] + disp;
      }
      meshes.push(v);
      NAMES.push("sample " + i);
      addSampleButton("sample " + i, meshes.length - 1);
    });
    status.textContent = j.disp.length + " sampled";
    setMesh(1);
  } catch (e) {
    status.textContent = "request failed: " + e;
  } finally {
    go.disabled = false;
  }
}
go.onclick = generate;
</script>"""


def export_html(
    meshes: np.ndarray,
    faces: np.ndarray,
    path: str,
    title: str = "cape_tpu meshes",
    names: list[str] | None = None,
) -> str:
    """Write an interactive single-file HTML viewer for a mesh batch.

    meshes: [N, V, 3] (or [V, 3] for one mesh); faces: [F, 3] int.
    Returns `path`. The file is fully self-contained (data embedded as
    base64, renderer inline) and needs no network or installed packages.
    """
    meshes = np.asarray(meshes, np.float32)
    if meshes.ndim == 2:
        meshes = meshes[None]
    faces = np.asarray(faces, np.uint32)
    n, nv, _ = meshes.shape
    if names is None:
        names = [f"sample {i}" for i in range(n)]
    assert len(names) == n, (len(names), n)

    verts_b64 = [
        base64.b64encode(m.astype("<f4").tobytes()).decode("ascii") for m in meshes
    ]
    faces_b64 = base64.b64encode(faces.astype("<u4").tobytes()).decode("ascii")

    doc = (
        _TEMPLATE
        .replace("__TITLE__", html.escape(title))
        .replace("__NAMES__", json.dumps(list(names)))
        .replace("__NV__", str(nv))
        .replace("__NF__", str(len(faces)))
        .replace("__VERTS__", json.dumps(verts_b64))
        .replace("__FACES__", faces_b64)
        .replace("__LIVE__", "")
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(doc)
    return path


def live_viewer_html(
    template_verts: np.ndarray,
    faces: np.ndarray,
    demo_poses: np.ndarray,
    clo_dim: int,
    has_gmm: bool = False,
    mean: np.ndarray | None = None,
    std: np.ndarray | None = None,
    title: str = "cape_tpu live viewer",
) -> str:
    """The /viewer page for apps.server: the embedded-template variant of
    the WebGL renderer plus controls that POST the serving process's own
    /sample endpoint and display the returned displacements — the live
    replacement for the reference's windowed MeshViewers
    (reference demos.py:225-246) on display-less hosts.

    template_verts [V, 3] NATURAL vertex order; faces [F, 3];
    demo_poses [P, cond_dim] rows offered as condition choices; mean/std
    [V, 3] train displacement stats (None -> identity: the server then
    shows raw model output, still a valid smoke surface)."""
    template_verts = np.asarray(template_verts, np.float32)
    faces = np.asarray(faces, np.uint32)
    demo_poses = np.asarray(demo_poses, np.float32)
    if demo_poses.ndim == 1:
        demo_poses = demo_poses[None]

    def b64(a):
        return json.dumps(
            base64.b64encode(np.asarray(a, "<f4").ravel().tobytes()).decode("ascii")
        )

    doc = (
        _TEMPLATE
        .replace("__TITLE__", html.escape(title))
        .replace("__NAMES__", json.dumps(["template"]))
        .replace("__NV__", str(len(template_verts)))
        .replace("__NF__", str(len(faces)))
        .replace("__VERTS__", json.dumps(
            [base64.b64encode(template_verts.astype("<f4").tobytes()).decode("ascii")]
        ))
        .replace("__FACES__", base64.b64encode(faces.astype("<u4").tobytes()).decode("ascii"))
    )
    live = (
        _LIVE_SCRIPT
        .replace("__MEAN__", b64(mean) if mean is not None else "null")
        .replace("__STD__", b64(std) if std is not None else "null")
        .replace("__POSES__", json.dumps(np.round(demo_poses, 6).tolist()))
        .replace("__CLODIM__", str(int(clo_dim)))
        .replace("__HASGMM__", "true" if has_gmm else "false")
    )
    return doc.replace("__LIVE__", live)
