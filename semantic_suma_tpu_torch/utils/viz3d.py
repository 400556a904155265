"""Interactive 3D map viewer: a self-contained WebGL HTML export
(counterpart of ``semantic_suma_tpu/utils/viz3d.py``).

One standalone ``.html`` file holds the surfel cloud (semantic colours), the
estimated trajectory and a vehicle glyph at the final pose, drawn by an
embedded WebGL point renderer with orbit / zoom / pan controls. It loads no
outside script and fetches nothing. :func:`export_html` writes the same
bytes as the JAX package's for the same arrays.
"""

from __future__ import annotations

import base64

import numpy as np

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 html,body{{margin:0;height:100%;background:#101014;color:#ccc;
   font:12px monospace;overflow:hidden}}
 #hud{{position:absolute;left:8px;top:8px;pointer-events:none}}
 canvas{{width:100%;height:100%;display:block}}
</style></head><body>
<div id="hud">{title} — {n_pts} surfels, {n_traj} poses.
 drag: orbit | shift-drag: pan | wheel: zoom | t: trajectory | g: ground grid</div>
<canvas id="c"></canvas>
<script>
"use strict";
function decode(b64, T) {{
  const s = atob(b64); const a = new Uint8Array(s.length);
  for (let i = 0; i < s.length; i++) a[i] = s.charCodeAt(i);
  return new T(a.buffer);
}}
const pos = decode("{pos_b64}", Float32Array);
const col = decode("{col_b64}", Uint8Array);
const traj = decode("{traj_b64}", Float32Array);
const car = decode("{car_b64}", Float32Array);
const N = pos.length / 3;

const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl");
const vs = `attribute vec3 p; attribute vec3 c; uniform mat4 mvp;
 uniform float ps; varying vec3 vc;
 void main(){{ gl_Position = mvp*vec4(p,1.0); vc = c;
   gl_PointSize = max(1.0, ps/max(gl_Position.w, 0.5)); }}`;
const fs = `precision mediump float; varying vec3 vc;
 void main(){{ gl_FragColor = vec4(vc, 1.0); }}`;
function prog(v, f) {{
  const p = gl.createProgram();
  for (const [t, src] of [[gl.VERTEX_SHADER, v], [gl.FRAGMENT_SHADER, f]]) {{
    const s = gl.createShader(t); gl.shaderSource(s, src);
    gl.compileShader(s); gl.attachShader(p, s);
  }}
  gl.linkProgram(p); return p;
}}
const P = prog(vs, fs);
gl.useProgram(P);
const aP = gl.getAttribLocation(P, "p"), aC = gl.getAttribLocation(P, "c");
const uM = gl.getUniformLocation(P, "mvp"), uS = gl.getUniformLocation(P, "ps");
function buf(data) {{
  const b = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, b);
  gl.bufferData(gl.ARRAY_BUFFER, data, gl.STATIC_DRAW); return b;
}}
const colf = new Float32Array(col.length);
for (let i = 0; i < col.length; i++) colf[i] = col[i] / 255.0;
const bP = buf(pos), bC = buf(colf), bT = buf(traj), bCar = buf(car);
const white = (n, r, g, b) => {{
  const a = new Float32Array(n * 3);
  for (let i = 0; i < n; i++) {{ a[3*i] = r; a[3*i+1] = g; a[3*i+2] = b; }}
  return a;
}};
const bTC = buf(white(traj.length / 3, 1.0, 0.35, 0.2));
const bCarC = buf(white(car.length / 3, 0.3, 0.9, 1.0));
// ground grid
const G = [];
for (let i = -10; i <= 10; i++) {{
  G.push(i*10, -100, 0, i*10, 100, 0, -100, i*10, 0, 100, i*10, 0);
}}
const grid = new Float32Array(G), bG = buf(grid);
const bGC = buf(white(grid.length / 3, 0.22, 0.22, 0.26));

// camera: orbit around centroid
let cx = 0, cy = 0, cz = 0;
for (let i = 0; i < Math.min(N, 5000); i++) {{
  const j = Math.floor(i * N / Math.min(N, 5000));
  cx += pos[3*j]; cy += pos[3*j+1]; cz += pos[3*j+2];
}}
const M = Math.min(N, 5000); cx /= M; cy /= M; cz /= M;
let yaw = 0.7, pitch = 0.9, dist = 120, panx = 0, pany = 0;
let showTraj = true, showGrid = true;
function mat(w, h) {{
  const f = 1.2, aspect = w / h, zn = 0.5, zf = 4000;
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const cyw = Math.cos(yaw), syw = Math.sin(yaw);
  // eye on a sphere (z-up world)
  const ex = cx + panx + dist * cp * cyw;
  const ey = cy + pany + dist * cp * syw;
  const ez = cz + dist * sp;
  const tx = cx + panx, ty = cy + pany, tz = cz;
  let zx = ex-tx, zy = ey-ty, zz = ez-tz;
  const zl = Math.hypot(zx, zy, zz); zx/=zl; zy/=zl; zz/=zl;
  let xx = -zy, xy = zx, xz = 0;          // up = +z world
  const xl = Math.hypot(xx, xy, xz) || 1; xx/=xl; xy/=xl; xz/=xl;
  const yx = zy*xz - zz*xy, yy = zz*xx - zx*xz, yz = zx*xy - zy*xx;
  const fx = f/aspect, fy = f;
  const a = zf/(zn-zf), b = zn*zf/(zn-zf);
  const dotx = -(xx*ex + xy*ey + xz*ez);
  const doty = -(yx*ex + yy*ey + yz*ez);
  const dotz = -(zx*ex + zy*ey + zz*ez);
  return new Float32Array([
    fx*xx, fy*yx, a*zx, zx,
    fx*xy, fy*yy, a*zy, zy,
    fx*xz, fy*yz, a*zz, zz,
    fx*dotx, fy*doty, a*dotz + b, dotz]);
}}
function drawBuf(b, c, n, mode, psize) {{
  gl.bindBuffer(gl.ARRAY_BUFFER, b);
  gl.enableVertexAttribArray(aP);
  gl.vertexAttribPointer(aP, 3, gl.FLOAT, false, 0, 0);
  gl.bindBuffer(gl.ARRAY_BUFFER, c);
  gl.enableVertexAttribArray(aC);
  gl.vertexAttribPointer(aC, 3, gl.FLOAT, false, 0, 0);
  gl.uniform1f(uS, psize);
  gl.drawArrays(mode, 0, n);
}}
function render() {{
  const w = canvas.clientWidth, h = canvas.clientHeight;
  if (canvas.width !== w || canvas.height !== h) {{
    canvas.width = w; canvas.height = h;
  }}
  gl.viewport(0, 0, w, h);
  gl.enable(gl.DEPTH_TEST);
  gl.clearColor(0.063, 0.063, 0.078, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  gl.uniformMatrix4fv(uM, false, mat(w, h));
  if (showGrid) drawBuf(bG, bGC, grid.length / 3, gl.LINES, 1.0);
  drawBuf(bP, bC, N, gl.POINTS, 90.0);
  if (showTraj && traj.length) {{
    drawBuf(bT, bTC, traj.length / 3, gl.LINE_STRIP, 1.0);
  }}
  if (car.length) drawBuf(bCar, bCarC, car.length / 3, gl.LINES, 1.0);
  requestAnimationFrame(render);
}}
let drag = false, panmode = false, lx = 0, ly = 0;
canvas.onmousedown = e => {{ drag = true; panmode = e.shiftKey;
  lx = e.clientX; ly = e.clientY; }};
window.onmouseup = () => drag = false;
window.onmousemove = e => {{
  if (!drag) return;
  const dx = e.clientX - lx, dy = e.clientY - ly;
  lx = e.clientX; ly = e.clientY;
  if (panmode) {{
    panx += (-dx * Math.sin(yaw) - dy * Math.cos(yaw)) * dist * 0.002;
    pany += (dx * Math.cos(yaw) - dy * Math.sin(yaw)) * dist * 0.002;
  }} else {{
    yaw += dx * 0.008;
    pitch = Math.min(1.45, Math.max(-1.45, pitch + dy * 0.008));
  }}
}};
canvas.onwheel = e => {{ e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.001); dist = Math.min(2000, Math.max(3, dist)); }};
window.onkeydown = e => {{
  if (e.key === "t") showTraj = !showTraj;
  if (e.key === "g") showGrid = !showGrid;
}};
render();
</script></body></html>
"""


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def _car_glyph(pose: np.ndarray | None) -> np.ndarray:
    """Vehicle wireframe (the KIT car model stand-in): a 4.4 x 1.8 x 1.4 m
    box + heading arrow, as GL_LINES segments in world frame."""
    if pose is None:
        return np.zeros((0, 3), np.float32)
    lx, ly, lz = 2.2, 0.9, 0.7
    c = np.array([[sx, sy, sz] for sx in (-lx, lx) for sy in (-ly, ly)
                  for sz in (0.0, 2 * lz)], np.float32)
    edges = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7),
             (6, 7), (0, 4), (1, 5), (2, 6), (3, 7)]
    segs = [c[a] for e in edges for a in e]
    # heading arrow (x-forward)
    segs += [np.array(v, np.float32) for v in
             ((lx, 0, lz), (lx + 1.5, 0, lz),
              (lx + 1.5, 0, lz), (lx + 1.0, 0.4, lz),
              (lx + 1.5, 0, lz), (lx + 1.0, -0.4, lz))]
    segs = np.stack(segs)
    r, t = np.asarray(pose)[:3, :3], np.asarray(pose)[:3, 3]
    return (segs @ r.T + t).astype(np.float32)


def export_html(path: str, positions: np.ndarray, colors: np.ndarray,
                trajectory: np.ndarray | None = None,
                car_pose: np.ndarray | None = None,
                title: str = "semantic_suma_tpu map",
                max_points: int = 400_000) -> None:
    """Write a standalone interactive viewer.

    positions: [N, 3] float; colors: [N, 3] uint8; trajectory: [T, 4, 4]
    or [T, 3]; car_pose: [4, 4] (defaults to the last trajectory pose).
    """
    positions = np.asarray(positions, np.float32)
    colors = np.asarray(colors, np.uint8)
    n = positions.shape[0]
    if n > max_points:
        sel = np.random.default_rng(0).choice(n, max_points, replace=False)
        sel.sort()
        positions, colors = positions[sel], colors[sel]
    tr = np.zeros((0, 3), np.float32)
    if trajectory is not None and len(trajectory):
        trajectory = np.asarray(trajectory)
        tr = (trajectory[:, :3, 3] if trajectory.ndim == 3
              else trajectory[:, :3]).astype(np.float32)
        if car_pose is None and trajectory.ndim == 3:
            car_pose = trajectory[-1]
    car = _car_glyph(car_pose)
    html = _HTML.format(
        title=title, n_pts=positions.shape[0], n_traj=tr.shape[0],
        pos_b64=_b64(positions), col_b64=_b64(colors),
        traj_b64=_b64(tr), car_b64=_b64(car))
    with open(path, "w") as f:
        f.write(html)
    print(f"wrote interactive viewer ({positions.shape[0]} pts) to {path}")


def export_map_html(path: str, state, map_cfg, trajectory=None,
                    min_confidence: float = 0.0,
                    max_points: int = 400_000) -> None:
    """Export a ``SurfelSLAM`` session's map (its ``SlamState``, on any
    device) and trajectory as viewer HTML."""
    from ..core.surfel_map import sync
    from ..device import AsyncFetch
    from ..models.labels import label_colors
    d = sync(state.map, map_cfg).data
    valid = AsyncFetch(d.valid).wait() & (AsyncFetch(d.confidence).wait()
                                          >= min_confidence)
    pos = AsyncFetch(d.wpos).wait()[valid]
    rgb = label_colors(AsyncFetch(d.sem_label).wait()[valid])
    export_html(path, pos, rgb, trajectory=trajectory,
                max_points=max_points)
