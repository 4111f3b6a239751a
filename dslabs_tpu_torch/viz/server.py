"""Trace -> HTML rendering + the @viz_ignore field annotation.

The reference renders live object trees with reflection and diff
highlighting (JTrees.java:146-268: NEW/CHANGED/DELETED) and hides fields
annotated @VizIgnore (VizIgnore.java:30-37).  Here each state along the
causal trace is dumped once to JSON (field name -> repr, honouring
``viz_ignore``) and a static page does navigation + diffing client-side —
no server process, no Swing: ``serve_trace`` writes the page next to the
trace and prints its path."""

from __future__ import annotations

import html
import json
import os
from typing import List, Optional

__all__ = ["viz_ignore", "render_trace_html", "serve_trace", "state_dump"]


def viz_ignore(*field_names: str):
    """Class decorator marking fields hidden from the debugger
    (@VizIgnore analog): ``@viz_ignore("cache", "_tmp")``."""

    def deco(cls):
        existing = getattr(cls, "__viz_ignore__", ())
        cls.__viz_ignore__ = tuple(existing) + tuple(field_names)
        return cls

    return deco


def _node_fields(node) -> dict:
    ignored = set(getattr(type(node), "__viz_ignore__", ()))
    out = {}
    for k, v in vars(node).items():
        if k.startswith("_") or k in ignored:
            continue
        out[k] = repr(v)
    return out


def state_dump(state) -> dict:
    """One search state -> JSON-able dict (nodes, network, timers)."""
    nodes = {}
    for a in state.addresses():
        nodes[str(a)] = _node_fields(state.node(a))
    net = sorted(repr(m) for m in state.network())
    timers = {}
    for a in state.addresses():
        tq = state.timers(a)
        if tq is not None:
            rows = [repr(t) for t in tq]
            if rows:
                timers[str(a)] = rows
    return {"nodes": nodes, "network": net, "timers": timers}


def trace_dump(trace) -> List[dict]:
    """SerializableTrace -> per-step dumps: [{event, state}]."""
    state = trace.initial_state()
    steps = [{"event": "(initial state)", "state": state_dump(state)}]
    for event in trace.history:
        nxt = state.step_event(event, None, skip_checks=True)
        if nxt is None:
            steps.append({"event": f"UNDELIVERABLE: {event!r}",
                          "state": state_dump(state)})
            break
        state = nxt
        steps.append({"event": repr(event), "state": state_dump(state)})
    return steps


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>dslabs trace: __TITLE__</title>
<style>
 body { font-family: ui-monospace, Menlo, monospace; margin: 0;
        background: #11151a; color: #d6dde6; }
 header { padding: 10px 16px; background: #1a212b;
          display: flex; gap: 14px; align-items: center; }
 header b { color: #7fd1b9; }
 button { background: #2b3a4d; color: #d6dde6; border: 0;
          padding: 6px 14px; border-radius: 4px; cursor: pointer; }
 button:disabled { opacity: .4 }
 #event { padding: 8px 16px; color: #e8c268; white-space: pre-wrap; }
 main { display: flex; flex-wrap: wrap; gap: 12px; padding: 0 16px 16px; }
 .panel { background: #1a212b; border-radius: 6px; padding: 10px 12px;
          min-width: 280px; max-width: 520px; flex: 1; }
 .panel h3 { margin: 0 0 6px; color: #8ab4f8; font-size: 14px; }
 .field { padding: 1px 0; font-size: 12.5px; white-space: pre-wrap;
          word-break: break-all; }
 .field .k { color: #9aa7b5 }
 .changed { background: #3d3118; border-radius: 3px; }
 .lists { width: 100%; display: flex; gap: 12px; }
 .small { font-size: 12px; color: #9aa7b5 }
</style></head><body>
<header>
 <b>dslabs trace viewer</b>
 <button id="prev">&#8592; prev</button>
 <span id="pos"></span>
 <button id="next">next &#8594;</button>
 <span class="small">__TITLE__</span>
</header>
<div id="event"></div>
<main id="nodes"></main>
<main class="lists">
 <div class="panel" style="flex:2"><h3>network (message set)</h3>
   <div id="net"></div></div>
 <div class="panel"><h3>pending timers</h3><div id="timers"></div></div>
</main>
<script>
const STEPS = __STEPS__;
let i = 0;
function fields(cur, prev) {
  let out = "";
  const keys = Object.keys(cur);
  for (const k of keys) {
    const changed = prev && prev[k] !== cur[k];
    out += `<div class="field ${changed ? "changed" : ""}">` +
           `<span class="k">${esc(k)}</span> = ${esc(cur[k])}</div>`;
  }
  if (prev) for (const k of Object.keys(prev))
    if (!(k in cur))
      out += `<div class="field changed"><span class="k">${esc(k)}</span>` +
             ` (deleted)</div>`;
  return out;
}
function esc(s) { return String(s).replace(/&/g, "&amp;")
  .replace(/</g, "&lt;").replace(/>/g, "&gt;"); }
function render() {
  const s = STEPS[i], p = i > 0 ? STEPS[i - 1] : null;
  document.getElementById("pos").textContent = `step ${i}/${STEPS.length - 1}`;
  document.getElementById("event").textContent = s.event;
  let nh = "";
  for (const a of Object.keys(s.state.nodes)) {
    nh += `<div class="panel"><h3>${esc(a)}</h3>` +
          fields(s.state.nodes[a], p ? p.state.nodes[a] : null) + `</div>`;
  }
  document.getElementById("nodes").innerHTML = nh;
  const pnet = p ? new Set(p.state.network) : new Set();
  document.getElementById("net").innerHTML = s.state.network.map(
    m => `<div class="field ${pnet.has(m) ? "" : "changed"}">${esc(m)}</div>`
  ).join("");
  let th = "";
  for (const a of Object.keys(s.state.timers)) {
    for (const t of s.state.timers[a])
      th += `<div class="field">${esc(t)}</div>`;
  }
  document.getElementById("timers").innerHTML = th;
  document.getElementById("prev").disabled = i === 0;
  document.getElementById("next").disabled = i === STEPS.length - 1;
}
document.getElementById("prev").onclick = () => { if (i > 0) { i--; render(); } };
document.getElementById("next").onclick = () => { if (i < STEPS.length - 1) { i++; render(); } };
document.addEventListener("keydown", e => {
  if (e.key === "ArrowLeft") document.getElementById("prev").click();
  if (e.key === "ArrowRight") document.getElementById("next").click();
});
render();
</script></body></html>
"""


def render_trace_html(trace) -> str:
    steps = trace_dump(trace)
    title = html.escape(repr(trace))
    return (_PAGE.replace("__TITLE__", title)
            .replace("__STEPS__", json.dumps(steps).replace("</", "<\\/")))


def serve_trace(path: str, out_path: Optional[str] = None) -> int:
    """Render a saved trace to HTML next to it (SavedTraceViz.main
    analog, SavedTraceViz.java:31-55).  Returns a process exit code."""
    from dslabs_tpu_torch.search.trace import SerializableTrace

    trace = SerializableTrace.load(path)
    if trace is None:
        print(f"Could not load trace {path}")
        return 1
    out_path = out_path or path + ".html"
    with open(out_path, "w") as f:
        f.write(render_trace_html(trace))
    print(f"Trace rendered to {out_path} — open it in a browser "
          f"({len(trace.history)} events)")
    return 0
