"""Interactive architecture diagram: self-contained HTML/SVG.

The port's copy of ``maunet_tpu/analysis/diagram_html.py``: for the same
hyperparameters it renders the same bytes (the node texts describe the
model as the JAX package documents it).  A pannable, zoomable node graph
with animated edges for both model families, in the place of the
reference's streamlit-flow component (app_dev/app_src/model_diagram.py:
8-222), as one dependency-free HTML string (inline SVG and vanilla JS).  It
embeds in the research app through ``st.components.v1.html`` and writes to
a plain ``.html`` file otherwise; clicking a node opens a panel with the
channel widths of the checkpoint's hyperparameters.  The topology is
generated from the model family and its hyperparameters; embedding-fusion
edges are drawn in the reference's blue (#3d73c4), data edges in dark grey.
"""

from __future__ import annotations

import html as _html
import json
from dataclasses import dataclass, field

NODE_W, NODE_H = 168, 46
KIND_FILL = {
    "input": "#eef3fa",
    "encoder": "#cfe3f7",
    "decoder": "#d8f0d3",
    "embedding": "#fde6c4",
    "output": "#f3d9dc",
}
EMB_EDGE = "#3d73c4"  # reference edge_style stroke (model_diagram.py:82)
DATA_EDGE = "#444444"


@dataclass
class Node:
    id: str
    x: float
    y: float
    label: str
    kind: str = "encoder"
    detail: str = ""


@dataclass
class Edge:
    src: str
    dst: str
    fusion: bool = False  # embedding-fusion edge → blue


@dataclass
class Diagram:
    title: str
    nodes: list[Node] = field(default_factory=list)
    edges: list[Edge] = field(default_factory=list)

    def node(self, *args, **kw) -> Node:
        n = Node(*args, **kw)
        self.nodes.append(n)
        return n

    def edge(self, src: Node | str, dst: Node | str, fusion: bool = False):
        sid = src.id if isinstance(src, Node) else src
        did = dst.id if isinstance(dst, Node) else dst
        self.edges.append(Edge(sid, did, fusion))


def _metadata_label(meta_features: int) -> str:
    # reference model_diagram.py:9-14
    if meta_features == 4:
        return "(lat, lon, population, Δt)"
    if meta_features == 8:
        return "(lat, lon, pop, Δt, y1, m1, y2, m2)"
    return "Metadata"


def _hp(hp: dict) -> dict:
    return {
        "base_filters": int(hp.get("base_filters", 64)),
        "temporal": bool(hp.get("temporal_embeddings", True)),
        "metadata": bool(hp.get("metadata_embeddings", True)),
        "temporal_dim": int(hp.get("temporal_dim", 64)),
        "meta_dim": int(hp.get("meta_dim", 64)),
        "lstm_hidden": int(hp.get("lstm_hidden", hp.get("lstm_dim", 96))),
        "meta_features": int(hp.get("metadata_features",
                                    hp.get("meta_features", 8))),
        "seq_len": int(hp.get("temporal_length", hp.get("seq_len", 828))),
        "model_type": str(hp.get("model_type", "unet")),
    }


def _inputs_and_encoders(d: Diagram, p: dict, n_enc: int) -> list[Node]:
    """Shared input / embedding / encoder column; returns encoder nodes."""
    bf = p["base_filters"]
    y_meta, y_temp = 90 + n_enc * 110, 160 + n_enc * 110
    inp = d.node("in_spatial", 0, 40, "Spatial input stack", "input",
                 "23 channels: 9 RGB+NDVI+LST per epoch (t1, t2 state) + "
                 "5 Dynamic World one-hot-reduced bands — (B, H, W, 23) NHWC.")
    if p["metadata"]:
        m_in = d.node("in_meta", 0, y_meta, _metadata_label(p["meta_features"]),
                      "input", f"{p['meta_features']} scalar features per tile.")
        enc_m = d.node("enc_meta", 230, y_meta, "Metadata encoder MLP",
                       "embedding",
                       f"Linear({p['meta_features']}→64) → ReLU → "
                       f"Linear(64→{p['meta_dim']}); broadcast over the "
                       "spatial grid at fusion (closed-form conv on TPU — "
                       "docs/TRACE.md §3).")
        d.edge(m_in, enc_m, fusion=True)
    if p["temporal"]:
        t_in = d.node("in_temp", 0, y_temp, "Temperature history", "input",
                      f"CRU monthly anomaly series, length {p['seq_len']}, "
                      "z-scored vs the 1901–50 baseline.")
        enc_t = d.node("enc_temp", 230, y_temp,
                       f"Temporal encoder LSTM({p['lstm_hidden']})",
                       "embedding",
                       f"Masked LSTM over {p['seq_len']} months → last valid "
                       f"hidden state → Linear(→{p['temporal_dim']}); Pallas "
                       "full-sequence kernel on TPU (ops/pallas/lstm.py).")
        d.edge(t_in, enc_t, fusion=True)

    encs = []
    prev: Node = inp
    for i in range(n_enc):
        f = bf * 2 ** i
        deepest = i == n_enc - 1
        n = d.node(f"conv{i}_0", 230, 40 + i * 110,
                   f"conv{i}_0 — {f}ch" + ("  (deepest)" if deepest else ""),
                   "encoder",
                   f"VGGBlock: 2× [3×3 conv → BN → ReLU] at 1/{2 ** i} "
                   f"resolution, {f} channels"
                   + ("" if deepest else "; 2×2 maxpool to the next level."))
        d.edge(prev, n)
        encs.append(n)
        prev = n
    return encs


def unet_diagram(hp: dict) -> Diagram:
    """Classic U-Net with bottleneck fusion (reference
    app_dev/app_src/model_diagram.py:8-71; model: src/model.py:196-273)."""
    p = _hp(hp)
    bf = p["base_filters"]
    d = Diagram(f"metadata U-Net — base_filters={bf}")
    encs = _inputs_and_encoders(d, p, n_enc=4)

    emb_ch = (p["temporal_dim"] if p["temporal"] else 0) + \
             (p["meta_dim"] if p["metadata"] else 0)
    bott = d.node("bottleneck", 460, 40 + 4 * 110,
                  f"bottleneck conv4_0 — {bf * 16}ch", "encoder",
                  f"VGGBlock at 1/16 resolution over concat(pool(conv3_0)"
                  + (f" ‖ {emb_ch}ch broadcast embeddings" if emb_ch else "")
                  + f") → {bf * 16} channels.")
    d.edge(encs[-1], bott)
    if p["metadata"]:
        d.edge("enc_meta", bott, fusion=True)
    if p["temporal"]:
        d.edge("enc_temp", bott, fusion=True)

    prev: Node = bott
    for i in reversed(range(4)):
        f = bf * 2 ** i
        n = d.node(f"conv{i}_1", 690, 40 + i * 110,
                   f"conv{i}_1 — {f}ch ↑2", "decoder",
                   "Align-corners bilinear ×2 upsample (MXU matmul resize) "
                   f"→ concat skip conv{i}_0 → VGGBlock → {f} channels "
                   "(SplitConv: part-wise conv, no concat materialization).")
        d.edge(prev, n)
        d.edge(encs[i], n)
        prev = n

    final = d.node("final", 920, 40, "1×1 conv", "decoder",
                   "Head: 1×1 conv → 2 channels; NDVI through tanh, "
                   "LST identity (reference src/model.py:268-271).")
    out = d.node("out", 1150, 40, "Output (ΔNDVI, ΔLST)", "output",
                 "(B, H, W, 2) — predicted t2 NDVI and LST state.")
    d.edge(prev, final)
    d.edge(final, out)
    return d


def unetpp_diagram(hp: dict) -> Diagram:
    """U-Net++ dense grid with per-node fusion (reference
    app_dev/app_src/model_diagram.py:74-222; model: src/model.py:51-193)."""
    p = _hp(hp)
    bf = p["base_filters"]
    d = Diagram(f"metadata U-Net++ — base_filters={bf}")
    encs = _inputs_and_encoders(d, p, n_enc=5)

    grid: dict[tuple[int, int], Node] = {
        (i, 0): encs[i] for i in range(5)}
    emb = []
    if p["temporal"]:
        emb.append("enc_temp")
    if p["metadata"]:
        emb.append("enc_meta")
    for j in range(1, 5):            # decoder column
        for i in range(5 - j):       # level
            f = bf * 2 ** i
            n = d.node(f"conv{i}_{j}", 230 * (1 + j), 40 + i * 110,
                       f"conv{i}_{j} — {f}ch", "decoder",
                       f"Dense-grid node X({i},{j}): concat("
                       + " ‖ ".join(f"conv{i}_{k}" for k in range(j))
                       + f" ‖ ↑2 conv{i + 1}_{j - 1}"
                       + (" ‖ embeddings" if emb else "")
                       + f") → VGGBlock → {f} channels; lane-packed "
                       "fused Pallas conv at inference (docs/TRACE.md §7).")
            for k in range(j):       # same-level dense skips
                d.edge(grid[(i, k)], n)
            d.edge(grid[(i + 1, j - 1)], n)   # upsampled deeper node
            for e in emb:            # per-node embedding fusion
                d.edge(e, n, fusion=True)
            grid[(i, j)] = n

    final = d.node("final", 230 * 6, 40, "1×1 conv", "decoder",
                   "Deep supervision: heads on conv0_1..conv0_4 during "
                   "training (averaged loss); conv0_4's head serves.")
    out = d.node("out", 230 * 6 + 230, 40, "Output (ΔNDVI, ΔLST)", "output",
                 "(B, H, W, 2) — predicted t2 NDVI and LST state.")
    d.edge(grid[(0, 4)], final)
    d.edge(final, out)
    return d


def model_diagram(hp: dict) -> Diagram:
    """Dispatch on model_type (reference model_diagram.py:216-222)."""
    if _hp(hp)["model_type"] in ("unet++", "unetpp"):
        return unetpp_diagram(hp)
    return unet_diagram(hp)


# --------------------------------------------------------------------------
# rendering

_CSS = """
  .mau-wrap { font: 13px system-ui, sans-serif; position: relative;
              border: 1px solid #ddd; border-radius: 8px; overflow: hidden;
              background: #fafbfc; }
  .mau-svg { cursor: grab; display: block; }
  .mau-svg:active { cursor: grabbing; }
  .mau-node rect { stroke: #333; stroke-width: 1; rx: 7;
                   filter: drop-shadow(0 1px 1.5px rgba(0,0,0,.18)); }
  .mau-node { cursor: pointer; }
  .mau-node.sel rect { stroke: #c0392b; stroke-width: 2.5; }
  .mau-node text { pointer-events: none; }
  .mau-edge { fill: none; stroke-width: 1.6;
              stroke-dasharray: 6 4; animation: mau-dash 0.9s linear infinite; }
  .mau-edge.hot { stroke-width: 3; }
  @keyframes mau-dash { to { stroke-dashoffset: -10; } }
  .mau-panel { position: absolute; top: 10px; right: 10px; width: 280px;
               background: #fff; border: 1px solid #ccc; border-radius: 8px;
               padding: 10px 12px; box-shadow: 0 2px 8px rgba(0,0,0,.15);
               display: none; }
  .mau-panel h4 { margin: 0 0 6px; font-size: 14px; }
  .mau-panel p { margin: 0; color: #333; line-height: 1.45; }
  .mau-hint { position: absolute; left: 10px; bottom: 8px; color: #888;
              font-size: 11px; }
"""

_JS = """
  (function(){
    const root = document.currentScript.parentElement;
    const svg = root.querySelector('svg');
    const view = svg.querySelector('.mau-view');
    const panel = root.querySelector('.mau-panel');
    const details = JSON.parse(root.querySelector('.mau-data').textContent);
    let tx = 20, ty = 16, scale = 1, drag = null, sel = null;
    const apply = () => view.setAttribute(
      'transform', `translate(${tx},${ty}) scale(${scale})`);
    apply();
    svg.addEventListener('mousedown', e => {
      drag = {x: e.clientX, y: e.clientY, tx, ty}; });
    window.addEventListener('mousemove', e => {
      if (!drag) return;
      tx = drag.tx + e.clientX - drag.x; ty = drag.ty + e.clientY - drag.y;
      apply(); });
    window.addEventListener('mouseup', () => drag = null);
    svg.addEventListener('wheel', e => {
      e.preventDefault();
      const f = e.deltaY < 0 ? 1.12 : 1/1.12;
      const r = svg.getBoundingClientRect();
      const mx = e.clientX - r.left, my = e.clientY - r.top;
      tx = mx - f * (mx - tx); ty = my - f * (my - ty); scale *= f;
      apply(); }, {passive: false});
    const hot = (id, on) => root.querySelectorAll(
      `.mau-edge[data-src="${id}"], .mau-edge[data-dst="${id}"]`)
      .forEach(p => p.classList.toggle('hot', on));
    root.querySelectorAll('.mau-node').forEach(g => {
      const id = g.dataset.id;
      g.addEventListener('mouseenter', () => hot(id, true));
      g.addEventListener('mouseleave', () => { if (sel !== id) hot(id, false); });
      g.addEventListener('click', e => {
        e.stopPropagation();
        if (sel) { root.querySelector(`.mau-node[data-id="${sel}"]`)
                   .classList.remove('sel'); hot(sel, false); }
        sel = id; g.classList.add('sel'); hot(id, true);
        panel.querySelector('h4').textContent = details[id].label;
        panel.querySelector('p').textContent = details[id].detail;
        panel.style.display = 'block'; });
    });
    svg.addEventListener('click', () => {
      if (sel) { root.querySelector(`.mau-node[data-id="${sel}"]`)
                 .classList.remove('sel'); hot(sel, false); sel = null; }
      panel.style.display = 'none'; });
  })();
"""


def _edge_path(a: Node, b: Node) -> str:
    """Cubic bezier from a's right edge to b's left edge (streamlit-flow's
    source_position='right' / target_position='left' convention)."""
    x1, y1 = a.x + NODE_W, a.y + NODE_H / 2
    x2, y2 = b.x, b.y + NODE_H / 2
    dx = max(40.0, (x2 - x1) * 0.5)
    return f"M{x1:.0f},{y1:.0f} C{x1 + dx:.0f},{y1:.0f} " \
           f"{x2 - dx:.0f},{y2:.0f} {x2:.0f},{y2:.0f}"


def render_html(diagram: Diagram, height: int = 560) -> str:
    """Render to one self-contained HTML string."""
    by_id = {n.id: n for n in diagram.nodes}
    for e in diagram.edges:
        if e.src not in by_id or e.dst not in by_id:
            raise ValueError(f"edge {e.src}->{e.dst} references unknown node")

    parts = [f'<div class="mau-wrap" style="height:{height}px">',
             f"<style>{_CSS}</style>",
             f'<svg class="mau-svg" width="100%" height="{height}">',
             '<g class="mau-view">']
    for e in diagram.edges:
        color = EMB_EDGE if e.fusion else DATA_EDGE
        parts.append(
            f'<path class="mau-edge" data-src="{e.src}" data-dst="{e.dst}" '
            f'stroke="{color}" d="{_edge_path(by_id[e.src], by_id[e.dst])}"/>')
    for n in diagram.nodes:
        fill = KIND_FILL.get(n.kind, "#eeeeee")
        parts.append(
            f'<g class="mau-node" data-id="{n.id}">'
            f'<rect x="{n.x:.0f}" y="{n.y:.0f}" width="{NODE_W}" '
            f'height="{NODE_H}" fill="{fill}"/>'
            f'<text x="{n.x + NODE_W / 2:.0f}" y="{n.y + NODE_H / 2 + 4:.0f}" '
            f'text-anchor="middle">{_html.escape(n.label)}</text></g>')
    details = {n.id: {"label": n.label, "detail": n.detail}
               for n in diagram.nodes}
    parts += [
        "</g></svg>",
        '<div class="mau-panel"><h4></h4><p></p></div>',
        f'<div class="mau-hint">{_html.escape(diagram.title)} — drag to pan, '
        "wheel to zoom, click a node for details</div>",
        # \u003c-escape so a '</script>' in any label cannot terminate the
        # JSON block early (JSON.parse decodes it back)
        '<script type="application/json" class="mau-data">'
        f'{json.dumps(details).replace("<", "\\u003c")}</script>',
        f"<script>{_JS}</script>",
        "</div>",
    ]
    return "\n".join(parts)


def save_html(hp: dict, path: str, height: int = 560) -> str:
    """Write the standalone page for a checkpoint's hyperparams; returns path."""
    body = render_html(model_diagram(hp), height=height)
    doc = ("<!doctype html><html><head><meta charset='utf-8'>"
           "<title>MAUNet architecture</title></head>"
           f"<body style='margin:0'>{body}</body></html>")
    with open(path, "w") as f:
        f.write(doc)
    return path
