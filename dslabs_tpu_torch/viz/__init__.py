"""Visual debugger — web-based trace viewer.

Re-design of the reference's Swing debugger (visualization/
DebuggerWindow.java:89, JTrees.java:89-1052, VizConfig.java:46-131) as a
self-contained static HTML page: per-node state panels with field-level
diff highlighting between consecutive states, the delivered-event list
with step navigation, and the pending message/timer views.  Consumes the
same SerializableTrace format the harness saves (`-s`) and the CLI opens
(`run_tests.py --visualize-trace FILE`)."""

from dslabs_tpu_torch.viz.config import VizConfig, register_viz_config, viz_configs
from dslabs_tpu_torch.viz.server import render_trace_html, serve_trace, viz_ignore

__all__ = ["render_trace_html", "serve_trace", "viz_ignore", "VizConfig",
           "register_viz_config", "viz_configs"]
