"""Lightweight web viewer: binary trajectory export + self-contained HTML player.

The port's own copy of adaptive_sph_tpu/utils/web_export.py (the files are
byte for byte the same): compact per-frame binaries of positions, radii and
colours, and a standalone HTML viewer that draws the particle field on a
canvas with pan / zoom and an optional metaball-style composite.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np


class WebExporter:
    """Writes frame-%06d.bin files: [uint32 n][n*f32 x][n*f32 y][n*f32 r][n*u8 rgb]."""

    def __init__(self, directory: str, scene_width: float = 2.0):
        self.directory = directory
        self.frames = []
        self.scene_width = scene_width
        self.boundary = []
        os.makedirs(directory, exist_ok=True)

    def set_boundary_segments(self, segs):
        self.boundary = np.asarray(segs, np.float32).reshape(-1, 4).tolist()

    def add_frame(self, time: float, positions, radii, colors_u8):
        n = len(positions)
        name = f"frame-{len(self.frames):06d}.bin"
        with open(os.path.join(self.directory, name), "wb") as f:
            f.write(struct.pack("<I", n))
            f.write(np.ascontiguousarray(positions[:, 0], np.float32).tobytes())
            f.write(np.ascontiguousarray(positions[:, 1], np.float32).tobytes())
            f.write(np.ascontiguousarray(radii, np.float32).tobytes())
            f.write(np.ascontiguousarray(colors_u8, np.uint8).tobytes())
        self.frames.append({"file": name, "time": float(time), "n": n})

    def finalize(self):
        meta = {
            "frames": self.frames,
            "scene_width": self.scene_width,
            "boundary": self.boundary,
        }
        with open(os.path.join(self.directory, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(self.directory, "index.html"), "w") as f:
            f.write(VIEWER_HTML)


VIEWER_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>adaptive-sph-tpu viewer</title>
<style>
  body { margin: 0; background: #111; color: #ddd; font-family: sans-serif; }
  #hud { position: fixed; top: 8px; left: 8px; background: rgba(0,0,0,.5); padding: 6px 10px; border-radius: 6px; }
  canvas { display: block; }
</style>
</head>
<body>
<div id="hud">
  <button id="play">play</button>
  <input id="slider" type="range" min="0" max="0" value="0" style="width:240px">
  <label><input id="metaball" type="checkbox"> metaball</label>
  <span id="info"></span>
</div>
<canvas id="c"></canvas>
<script>
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
let meta = null, frames = {}, cur = 0, playing = false;
let zoom = 1.0, panX = 0, panY = 0;

function resize() { canvas.width = innerWidth; canvas.height = innerHeight; }
addEventListener('resize', () => { resize(); draw(); });
resize();

async function loadMeta() {
  meta = await (await fetch('meta.json')).json();
  document.getElementById('slider').max = meta.frames.length - 1;
  await loadFrame(0); draw();
}
async function loadFrame(i) {
  if (frames[i]) return frames[i];
  const buf = await (await fetch(meta.frames[i].file)).arrayBuffer();
  const n = new Uint32Array(buf, 0, 1)[0];
  const x = new Float32Array(buf, 4, n);
  const y = new Float32Array(buf, 4 + 4 * n, n);
  const r = new Float32Array(buf, 4 + 8 * n, n);
  const rgb = new Uint8Array(buf, 4 + 12 * n, 3 * n);
  frames[i] = { n, x, y, r, rgb };
  return frames[i];
}
function worldToScreen(wx, wy, scale) {
  return [canvas.width / 2 + (wx + panX) * scale, canvas.height / 2 - (wy + panY) * scale];
}
function draw() {
  if (!meta || !frames[cur]) return;
  const f = frames[cur];
  const scale = Math.min(canvas.width, canvas.height) / (meta.scene_width * 1.04) * zoom;
  const mb = document.getElementById('metaball').checked;
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, canvas.width, canvas.height);
  ctx.strokeStyle = '#888'; ctx.lineWidth = 2;
  for (const s of meta.boundary) {
    const [ax, ay] = worldToScreen(s[0], s[1], scale);
    const [bx, by] = worldToScreen(s[2], s[3], scale);
    ctx.beginPath(); ctx.moveTo(ax, ay); ctx.lineTo(bx, by); ctx.stroke();
  }
  // metaball-style composite: draw 2x radius with additive blur then threshold is
  // approximated by globalAlpha accumulation (reference webgl metaball pass)
  const rMul = mb ? 2.0 : 1.0;
  ctx.globalAlpha = mb ? 0.55 : 1.0;
  for (let i = 0; i < f.n; i++) {
    const [sx, sy] = worldToScreen(f.x[i], f.y[i], scale);
    const sr = Math.max(f.r[i] * scale * rMul, 0.75);
    ctx.fillStyle = `rgb(${f.rgb[3*i]},${f.rgb[3*i+1]},${f.rgb[3*i+2]})`;
    ctx.beginPath(); ctx.arc(sx, sy, sr, 0, 6.2832); ctx.fill();
  }
  ctx.globalAlpha = 1.0;
  document.getElementById('info').textContent =
    ` t=${meta.frames[cur].time.toFixed(3)}s  n=${f.n}  frame ${cur+1}/${meta.frames.length}`;
}
document.getElementById('slider').oninput = async (e) => { cur = +e.target.value; await loadFrame(cur); draw(); };
document.getElementById('play').onclick = () => { playing = !playing; };
document.getElementById('metaball').onchange = draw;
canvas.onwheel = (e) => { zoom *= e.deltaY < 0 ? 1.1 : 0.9; draw(); e.preventDefault(); };
let dragging = false, lx = 0, ly = 0;
canvas.onmousedown = (e) => { dragging = true; lx = e.clientX; ly = e.clientY; };
canvas.onmouseup = () => dragging = false;
canvas.onmousemove = (e) => {
  if (!dragging) return;
  const scale = Math.min(canvas.width, canvas.height) / (meta.scene_width * 1.04) * zoom;
  panX += (e.clientX - lx) / scale; panY -= (e.clientY - ly) / scale;
  lx = e.clientX; ly = e.clientY; draw();
};
setInterval(async () => {
  if (!playing || !meta) return;
  cur = (cur + 1) % meta.frames.length;
  document.getElementById('slider').value = cur;
  await loadFrame(cur); draw();
}, 1000 / 30);
loadMeta();
</script>
</body>
</html>
"""
