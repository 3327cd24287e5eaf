"""Interactive editor shell (browser UI) for an AnalysisSession.

Counterpart of :mod:`signalizer_tpu.editor`. The reference's editor layer
(MainEditor window + SignalizerDesign widget kit + per-view Controllers +
GraphEditor) rebuilt as a dependency-free web app: :mod:`widgets`
resolves the controller layouts against live parameters, :mod:`server`
serves the app + JSON API and drives the tick loop, :mod:`static` is the
page. Launch with::

    python -m signalizer_tpu_torch editor      # demo signal source, on the GPU
    # or embed:
    shell = EditorShell(session, source=my_block_source)
    shell.start(); print(shell.url)
"""

from signalizer_tpu_torch.editor.server import EditorShell
from signalizer_tpu_torch.editor.widgets import describe_pages, resolve_control, tier_of

__all__ = ["EditorShell", "describe_pages", "resolve_control", "tier_of"]
