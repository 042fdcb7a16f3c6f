"""The two sides of a parity test of the serving surface.

``JAX_S`` and ``PORT_S`` extend the sides of ``_torch_general`` with the
serving modules of each package (``wire``, ``talk``, ``client``, ``window``,
``app``, ``fastserver``, ``checkpoint``, ``undo``, ``persist``, ``png``,
``tkclient``, ``messages``) and wrap the constructors whose signatures
differ: the port's ``Engine``, ``FastSession``, ``load_view``,
``load_sprite`` and ``load_shape`` take the device, and a test passes
``"cpu"``.  One scenario written against a side runs on both.

The socket pair, the driven client and the thread helpers come from
``_torch_sockets``, which imports neither package.
"""

from types import SimpleNamespace

import numpy as np

from _torch_general import DEV, JAX, PORT
from _torch_sockets import DEADLINE, RecordingSocket, ServedClient, crc, in_thread, socket_pair, wait_for  # noqa: F401

import coherence_tpu.gui.app as j_app
import coherence_tpu.gui.client as j_client
import coherence_tpu.gui.fastserver as j_fastserver
import coherence_tpu.gui.messages as j_messages
import coherence_tpu.gui.talk as j_talk
import coherence_tpu.gui.tkclient as j_tkclient
import coherence_tpu.gui.window as j_window
import coherence_tpu.gui.wire as j_wire
import coherence_tpu.scene.checkpoint as j_checkpoint
import coherence_tpu.scene.undo as j_undo
import coherence_tpu.utils.persist as j_persist
import coherence_tpu.utils.png as j_png

import coherence_tpu_torch.gui.app as t_app
import coherence_tpu_torch.gui.client as t_client
import coherence_tpu_torch.gui.fastserver as t_fastserver
import coherence_tpu_torch.gui.messages as t_messages
import coherence_tpu_torch.gui.talk as t_talk
import coherence_tpu_torch.gui.tkclient as t_tkclient
import coherence_tpu_torch.gui.window as t_window
import coherence_tpu_torch.gui.wire as t_wire
import coherence_tpu_torch.scene.checkpoint as t_checkpoint
import coherence_tpu_torch.scene.undo as t_undo
import coherence_tpu_torch.utils.persist as t_persist
import coherence_tpu_torch.utils.png as t_png


def _serving_side(base, dev, **mods):
    s = SimpleNamespace(**vars(base))
    for k, v in mods.items():
        setattr(s, k, v)
    kw = {"device": dev[0]} if dev else {}
    s.Engine = lambda **k: s.app.Engine(**k, **kw)
    s.FastSession = lambda *a, **k: s.fastserver.FastSession(*a, **k, **kw)
    s.load_view = lambda path: s.checkpoint.load_view(path, *dev)
    s.load_sprite = lambda path: s.persist.load_sprite(path, *dev)
    s.load_shape = lambda path: s.persist.load_shape(path, *dev)
    s.plane_np = (lambda t: t.numpy()) if dev else np.asarray
    return s


JAX_S = _serving_side(
    JAX, (), app=j_app, client=j_client, fastserver=j_fastserver, messages=j_messages, talk=j_talk,
    tkclient=j_tkclient, window=j_window, wire=j_wire, checkpoint=j_checkpoint, undo=j_undo, persist=j_persist,
    png=j_png,
)
PORT_S = _serving_side(
    PORT, (DEV,), app=t_app, client=t_client, fastserver=t_fastserver, messages=t_messages, talk=t_talk,
    tkclient=t_tkclient, window=t_window, wire=t_wire, checkpoint=t_checkpoint, undo=t_undo, persist=t_persist,
    png=t_png,
)
SERVING_SIDES = (JAX_S, PORT_S)
