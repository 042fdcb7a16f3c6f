"""Windowing, wire protocol, transport and the interactive engine.

The PyTorch counterpart of ``coherence_tpu.gui`` (reference layers 6-8:
wxgui.ml, camlpy.ml, pytalk.ml, main.py, mltalk.py, pycaml.py, engine.ml).
``wire``, ``talk``, ``messages``, ``client`` and ``tkclient`` are host code
and the port's own copies; ``window`` (the window system), ``app`` (the
Engine) and ``fastserver`` (FastSession) render through the port and take
the device they run on, the card unless the caller names the CPU.
"""
