"""Status-bar and help strings per tool state (parity: reference
``messages.ml``).

The port's copy of ``coherence_tpu.gui.messages``, unchanged."""

import sys

command = "Cmd" if sys.platform == "darwin" else "Ctrl"

nonesel = (
    f"Click to select an object; drag to select many; {command}-A to select all."
)

objsel = (
    "Drag to move selected objects; Right click adds to selection; "
    f"{command}-Click for multiple selections."
)

dragsize = (
    f"Hold {command} for proportional scaling. Hold shift to scale around centre"
)

dragrotate = (
    f"Hold {command} to constrain rotation. Drag crosshair to change centre."
)

dragrubberband = "Press escape to cancel."

zoomhints = "Drag to zoom to a rectangle; left and right buttons to zoom in/out"
