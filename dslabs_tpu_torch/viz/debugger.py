"""Interactive branch-exploring debugger (DebuggerWindow.java:89 +
EventTreeState.java:47-209 capability, web-native).

A tiny stdlib HTTP server holds an execution TREE over live
:class:`SearchState` objects: the client shows the current state with
field-level diff highlighting against its parent, lists the state's
PENDING events (deliverable messages + timers — exactly
``SearchState.events()``, so duplicate deliveries are offered the same
way ``EventTreeState`` detects "sends delivered messages"), and a click
delivers one, creating (or revisiting — steps are cached per
(node, event)) a child branch.  Navigation walks the whole explored
tree, not a fixed linear trace.

Entry points:
  * ``run_tests.py --debugger <lab> <vizconfig args>`` — from a lab's
    initial state (VizClient.java:39-102).
  * ``run_tests.py --visualize-trace <file>`` — the saved trace is
    replayed into an initial PATH through the tree; the user can step
    along it or deviate anywhere (SavedTraceViz.java:31-55 + branch
    exploration).
"""

from __future__ import annotations

import json
import threading
import webbrowser
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from dslabs_tpu_torch.viz.server import state_dump

__all__ = ["EventTree", "serve_debugger"]


class _TreeNode:
    __slots__ = ("id", "state", "parent", "event_repr", "children", "depth")

    def __init__(self, id_, state, parent, event_repr, depth):
        self.id = id_
        self.state = state
        self.parent = parent              # parent node id or None
        self.event_repr = event_repr      # repr of the event that made us
        self.children: Dict[int, int] = {}  # pending-event idx -> node id
        self.depth = depth


class EventTree:
    """Explored-execution tree over SearchStates (EventTreeState
    analog): step caching, path-from-initial, pending-event listing."""

    def __init__(self, initial_state, settings=None):
        self.settings = settings
        self.nodes: List[_TreeNode] = [
            _TreeNode(0, initial_state, None, "(initial state)", 0)]
        # ThreadingHTTPServer handles requests on separate threads; node
        # creation must be serialised or two concurrent /step calls
        # could mint the same node id.
        self._lock = threading.Lock()

    def pending(self, node_id: int) -> List:
        return self.nodes[node_id].state.events(self.settings)

    def step(self, node_id: int, event_idx: int) -> Optional[int]:
        """Deliver pending event ``event_idx`` of node ``node_id``;
        returns the child node id (cached if already explored) or None
        if the event is no longer deliverable."""
        with self._lock:
            node = self.nodes[node_id]
            if event_idx in node.children:
                return node.children[event_idx]
            events = self.pending(node_id)
            if not 0 <= event_idx < len(events):
                return None
            event = events[event_idx]
            child_state = node.state.step_event(event, self.settings,
                                                skip_checks=True)
            if child_state is None:
                return None
            child = _TreeNode(len(self.nodes), child_state, node_id,
                              repr(event), node.depth + 1)
            self.nodes.append(child)
            node.children[event_idx] = child.id
            return child.id

    def preload_path(self, events) -> List[int]:
        """Replay a recorded event list from the root into a path of
        tree nodes (the --visualize-trace entry)."""
        path = [0]
        node_id = 0
        for event in events:
            pend = self.pending(node_id)
            idx = next((i for i, e in enumerate(pend) if e == event), None)
            if idx is None:
                break
            nxt = self.step(node_id, idx)
            if nxt is None:
                break
            node_id = nxt
            path.append(node_id)
        return path

    # ------------------------------------------------------------- JSON

    def tree_json(self) -> dict:
        """The whole explored tree (StateTreeCanvas.java capability):
        one record per node, DFS-ordered so the client can lay out
        subtrees contiguously."""
        order: List[int] = []
        with self._lock:
            # Iterative DFS: preloaded traces can be thousands of events
            # deep — recursion would overflow inside the HTTP handler.
            stack = [0]
            while stack:
                nid = stack.pop()
                order.append(nid)
                kids = [cid for _, cid in
                        sorted(self.nodes[nid].children.items())]
                stack.extend(reversed(kids))
            return {"nodes": [{
                "id": nid,
                "parent": self.nodes[nid].parent,
                "depth": self.nodes[nid].depth,
                "event": self.nodes[nid].event_repr[:80],
            } for nid in order]}

    def node_json(self, node_id: int) -> dict:
        node = self.nodes[node_id]
        parent = (self.nodes[node.parent] if node.parent is not None
                  else None)
        pend = self.pending(node_id)
        # Ancestor path root-first — the trace breadcrumb.
        path = []
        cur = node
        while cur is not None:
            path.append({"id": cur.id, "event": cur.event_repr})
            cur = self.nodes[cur.parent] if cur.parent is not None else None
        path.reverse()
        return {
            "id": node.id,
            "depth": node.depth,
            "event": node.event_repr,
            "parent": node.parent,
            "state": state_dump(node.state),
            "parent_state": state_dump(parent.state) if parent else None,
            "pending": [{"idx": i, "repr": repr(e),
                         "kind": type(e).__name__,
                         "child": node.children.get(i)}
                        for i, e in enumerate(pend)],
            "path": path,
            "children": node.children,
            "n_nodes": len(self.nodes),
        }


_APP = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>dslabs debugger</title>
<style>
 body { font-family: ui-monospace, Menlo, monospace; margin: 0;
        background: #11151a; color: #d6dde6; }
 header { padding: 10px 16px; background: #1a212b; display: flex;
          gap: 14px; align-items: center; flex-wrap: wrap; }
 header b { color: #7fd1b9; }
 button { background: #2b3a4d; color: #d6dde6; border: 0;
          padding: 4px 10px; border-radius: 4px; cursor: pointer;
          font: inherit; font-size: 12px; }
 button:hover { background: #3b4f68; }
 button.visited { background: #24503d; }
 #crumb { padding: 6px 16px; color: #e8c268; font-size: 12px;
          white-space: pre-wrap; }
 #crumb a { color: #8ab4f8; cursor: pointer; text-decoration: none; }
 .cols { display: flex; gap: 12px; padding: 0 16px 16px;
         align-items: flex-start; }
 .events { background: #1a212b; border-radius: 6px; padding: 10px;
           width: 420px; flex-shrink: 0; }
 .events h3, .panel h3 { margin: 0 0 6px; color: #8ab4f8;
                         font-size: 14px; }
 .ev { display: flex; gap: 6px; margin: 3px 0; align-items: baseline; }
 .ev .r { font-size: 12px; word-break: break-all; }
 .statecols { display: flex; flex-wrap: wrap; gap: 12px; flex: 1; }
 .panel { background: #1a212b; border-radius: 6px; padding: 10px 12px;
          min-width: 260px; max-width: 520px; flex: 1; }
 .field { padding: 1px 0; font-size: 12.5px; white-space: pre-wrap;
          word-break: break-all; }
 .field .k { color: #9aa7b5 }
 .changed { background: #3d3118; border-radius: 3px; }
 .small { font-size: 12px; color: #9aa7b5 }
 #treewrap { background: #1a212b; border-radius: 6px; margin: 0 16px 12px;
             padding: 8px; overflow: auto; max-height: 260px; }
 #treewrap h3 { margin: 0 0 4px; color: #8ab4f8; font-size: 14px; }
 #tree circle { cursor: pointer; fill: #2b3a4d; stroke: #56718f; }
 #tree circle:hover { fill: #3b4f68; }
 #tree circle.onpath { fill: #24503d; stroke: #7fd1b9; }
 #tree circle.cur { fill: #e8c268; stroke: #e8c268; }
 #tree line { stroke: #31404f; stroke-width: 1.2; }
 #tree line.onpath { stroke: #7fd1b9; stroke-width: 2; }
 #tree text { fill: #9aa7b5; font-size: 9px; pointer-events: none; }
</style></head><body>
<header>
 <b>dslabs debugger</b>
 <button id="up">&#8593; parent</button>
 <span id="pos" class="small"></span>
 <span id="count" class="small"></span>
</header>
<div id="crumb"></div>
<div id="treewrap"><h3>explored tree (click a node to jump)</h3>
 <svg id="tree" width="100" height="100"></svg></div>
<div class="cols">
 <div class="events"><h3>pending events (click to deliver)</h3>
   <div id="pending"></div></div>
 <div class="statecols" id="nodes"></div>
</div>
<script>
let cur = 0;
function esc(s) { return String(s).replace(/&/g, "&amp;")
  .replace(/</g, "&lt;").replace(/>/g, "&gt;"); }
function fields(curF, prevF) {
  let out = "";
  for (const k of Object.keys(curF)) {
    const changed = prevF && prevF[k] !== curF[k];
    out += `<div class="field ${changed ? "changed" : ""}">` +
           `<span class="k">${esc(k)}</span> = ${esc(curF[k])}</div>`;
  }
  if (prevF) for (const k of Object.keys(prevF))
    if (!(k in curF))
      out += `<div class="field changed"><span class="k">${esc(k)}</span>` +
             ` (deleted)</div>`;
  return out;
}
let treeCache = null, treeCacheN = -1;
async function drawTree(pathIds, nNodes) {
  if (treeCacheN !== nNodes) {
    const r = await fetch(`/tree`);
    treeCache = await r.json();
    treeCacheN = nNodes;
  }
  const d = treeCache;
  const dx = 46, dy = 26, r0 = 7;
  const pos = {};                       // id -> [x, y]
  let row = 0;
  // DFS order from the server: a node's y is its subtree's first free
  // row; depth sets x — the classic left-to-right layered tree.
  const seenDepth = {};
  for (const n of d.nodes) {
    if (n.parent === null) { pos[n.id] = [0, row]; continue; }
    // place on parent's row if free, else next free row
    const py = pos[n.parent][1];
    let y = py;
    while (seenDepth[n.depth] !== undefined && y <= seenDepth[n.depth])
      y = seenDepth[n.depth] + 1;
    seenDepth[n.depth] = y;
    pos[n.id] = [n.depth, y];
    row = Math.max(row, y);
  }
  const onPath = new Set(pathIds);
  let maxX = 0, maxY = 0;
  let edges = "", nodes = "";
  for (const n of d.nodes) {
    const [x, y] = pos[n.id];
    maxX = Math.max(maxX, x); maxY = Math.max(maxY, y);
    if (n.parent !== null) {
      const [px, py] = pos[n.parent];
      const cls = onPath.has(n.id) && onPath.has(n.parent) ? "onpath" : "";
      edges += `<line class="${cls}" x1="${px*dx+16}" y1="${py*dy+16}" ` +
               `x2="${x*dx+16}" y2="${y*dy+16}"><title></title></line>`;
    }
    const cls = n.id === cur ? "cur" : (onPath.has(n.id) ? "onpath" : "");
    nodes += `<circle class="${cls}" cx="${x*dx+16}" cy="${y*dy+16}" ` +
             `r="${r0}" onclick="load(${n.id})">` +
             `<title>#${n.id} d${n.depth}: ${esc(n.event)}</title></circle>` +
             `<text x="${x*dx+12}" y="${y*dy+35}">${n.id}</text>`;
  }
  const svg = document.getElementById("tree");
  svg.setAttribute("width", maxX*dx+40);
  svg.setAttribute("height", maxY*dy+44);
  svg.innerHTML = edges + nodes;
}
async function load(id) {
  const r = await fetch(`/node/${id}`);
  const d = await r.json();
  cur = d.id;
  drawTree(d.path.map(p => p.id), d.n_nodes);
  document.getElementById("pos").textContent =
    `node ${d.id} · depth ${d.depth}`;
  document.getElementById("count").textContent =
    `· ${d.n_nodes} states explored`;
  document.getElementById("crumb").innerHTML = d.path.map(
    (p, i) => `<a onclick="load(${p.id})">[${i}]</a> ${esc(p.event)}`
  ).join("\\n");
  let ph = "";
  for (const e of d.pending) {
    const cls = e.child !== null && e.child !== undefined ? "visited" : "";
    ph += `<div class="ev"><button class="${cls}" ` +
          `onclick="deliver(${e.idx})">deliver</button>` +
          `<span class="r">${esc(e.repr)}</span></div>`;
  }
  document.getElementById("pending").innerHTML =
    ph || "<span class='small'>(no deliverable events)</span>";
  let nh = "";
  const prev = d.parent_state;
  for (const a of Object.keys(d.state.nodes)) {
    nh += `<div class="panel"><h3>${esc(a)}</h3>` +
          fields(d.state.nodes[a], prev ? prev.nodes[a] : null) + `</div>`;
  }
  const pnet = prev ? new Set(prev.network) : new Set();
  nh += `<div class="panel"><h3>network (message set)</h3>` +
        d.state.network.map(m =>
          `<div class="field ${pnet.has(m) ? "" : "changed"}">` +
          `${esc(m)}</div>`).join("") + `</div>`;
  let th = "";
  for (const a of Object.keys(d.state.timers))
    for (const t of d.state.timers[a])
      th += `<div class="field">${esc(t)}</div>`;
  nh += `<div class="panel"><h3>pending timers</h3>${th}</div>`;
  document.getElementById("nodes").innerHTML = nh;
  document.getElementById("up").disabled = d.parent === null;
  document.getElementById("up").onclick =
    () => { if (d.parent !== null) load(d.parent); };
}
async function deliver(idx) {
  const r = await fetch(`/step`, {method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify({id: cur, event: idx})});
  const d = await r.json();
  if (d.child !== null) load(d.child);
}
load(__START__);
</script></body></html>
"""


def serve_debugger(initial_state, settings=None, port: int = 0,
                   preload_events=None, open_browser: bool = True,
                   block: bool = True):
    """Serve the branch-exploring debugger on localhost; returns the
    (server, tree) pair (server already running on a daemon thread when
    ``block`` is False — used by the tests)."""
    tree = EventTree(initial_state, settings)
    start = 0
    if preload_events:
        path = tree.preload_path(preload_events)
        start = path[-1]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                body = _APP.replace("__START__", str(start)).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/tree":
                self._json(tree.tree_json())
            elif self.path.startswith("/node/"):
                try:
                    node_id = int(self.path[len("/node/"):])
                    self._json(tree.node_json(node_id))
                except (ValueError, IndexError):
                    self._json({"error": "bad node id"}, 404)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            if self.path != "/step":
                self._json({"error": "not found"}, 404)
                return
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            child = tree.step(int(req.get("id", 0)),
                              int(req.get("event", -1)))
            self._json({"child": child})

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    url = f"http://127.0.0.1:{server.server_address[1]}/"
    print(f"dslabs debugger at {url} (ctrl-c to stop)")
    if open_browser:
        try:
            webbrowser.open(url)
        except Exception:
            pass
    if block:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
    else:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
    return server, tree
