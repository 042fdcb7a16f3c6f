"""The port's wire format, transport, display client, PNG writer and status
strings (gui/wire, talk, client, messages, tkclient, utils/png: host code,
the port's own copies) against the JAX package's: the same seeded values
marshalled to the same bytes, and the two packages talking to each other
over real localhost sockets, a client of one serving a RemoteDisplay of the
other.  Tolerance 0."""

import os
import threading

import numpy as np
import pytest

from _torch_serving import DEADLINE, JAX_S, PORT_S, SERVING_SIDES, in_thread, socket_pair
from _torch_threads import one_torch_thread  # noqa: F401

IDS = [s.name for s in SERVING_SIDES]


def seeded_value(rng, depth=0):
    """A nested wire value: lists of ints, bools, None, byte strings."""
    kind = rng.integers(0, 6 if depth < 3 else 5)
    if kind == 0:
        return int(rng.integers(-2**31, 2**31))
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        return None
    if kind == 3:
        return rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8).tobytes()
    if kind == 4:
        return "".join(chr(int(c)) for c in rng.integers(32, 256, int(rng.integers(0, 12))))
    return [seeded_value(rng, depth + 1) for _ in range(int(rng.integers(0, 6)))]


def normalised(v):
    if isinstance(v, str):
        return v.encode("latin1")
    if isinstance(v, (list, tuple)):
        return [normalised(x) for x in v]
    return v


@pytest.mark.parametrize("seed", range(8))
def test_marshall_gives_the_same_bytes_and_round_trips(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        v = [seeded_value(rng) for _ in range(int(rng.integers(0, 5)))]
        framed = JAX_S.wire.marshall(v)
        assert PORT_S.wire.marshall(v) == framed
        for reader in SERVING_SIDES:
            n, out = reader.wire.unmarshall(framed)
            assert n == len(framed) and out == normalised(v)


@pytest.mark.parametrize("side", SERVING_SIDES, ids=IDS)
def test_wire_format_bytes_exact(side):
    wire = side.wire
    assert wire.marshall(258) == b"\x00\x00\x00\x05\x02\x00\x00\x01\x02"
    assert wire.marshall(None) == b"\x00\x00\x00\x01\x01"
    assert wire.marshall(True) == b"\x00\x00\x00\x02\x04\x01"
    assert wire.marshall(b"ab") == b"\x00\x00\x00\x07\x03\x00\x00\x00\x02ab"
    assert wire.marshall(("a", 1)) == wire.marshall(["a", 1])


@pytest.mark.parametrize("side", SERVING_SIDES, ids=IDS)
def test_wire_incremental_and_invalid(side):
    wire = side.wire
    frames = wire.marshall([1, 2]) + wire.marshall(b"xy")
    assert wire.unmarshall(frames[:3]) is None
    assert wire.unmarshall(frames[:7]) is None
    n, v1 = wire.unmarshall(frames)
    assert v1 == [1, 2]
    assert wire.unmarshall(frames[n:]) == (len(frames) - n, b"xy")
    with pytest.raises(wire.InvalidData):
        wire.unmarshall(b"\x00\x00\x00\x01\x09")
    with pytest.raises(wire.InvalidData):
        wire.unmarshall(b"\x00\x00\x00\x02\x01\x01")  # two values in one frame
    with pytest.raises(TypeError):
        wire.marshall(1.5)


@pytest.mark.parametrize("shape", [(7, 5), (9, 4, 3), (6, 8, 4), (1, 1, 3)])
def test_png_bytes_equal_and_round_trip(shape):
    img = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    data = JAX_S.png.png_bytes(img)
    assert PORT_S.png.png_bytes(img) == data
    for reader in SERVING_SIDES:
        assert np.array_equal(reader.png.read_png(data), img)


def test_png_files_and_clipping(tmp_path):
    img = np.random.default_rng(4).integers(-50, 400, (5, 6, 3))
    for writer, reader in ((JAX_S, PORT_S), (PORT_S, JAX_S)):
        p = str(tmp_path / f"{writer.name}.png")
        writer.png.write_png(p, img)
        assert np.array_equal(reader.png.read_png(p), np.clip(img, 0, 255).astype(np.uint8))
    assert open(tmp_path / "jax.png", "rb").read() == open(tmp_path / "port.png", "rb").read()


def test_status_strings_equal():
    names = [n for n in vars(JAX_S.messages) if not n.startswith("_") and isinstance(getattr(JAX_S.messages, n), str)]
    assert len(names) >= 7
    for n in names:
        assert getattr(PORT_S.messages, n) == getattr(JAX_S.messages, n)


def test_key_codes_and_event_names_equal():
    jw, tw = JAX_S.window, PORT_S.window
    for k in list(range(20, 100)) + [314, 315, 316, 317, 366, 367, 400]:
        assert tw.key_of_keycode(k) == jw.key_of_keycode(k)
    for n in vars(jw):
        if n.isupper() or n in ("Select", "Zoom", "Escape", "Left", "Up", "Right", "Down", "PageUp", "PageDown", "nullwindow"):
            assert getattr(tw, n) == getattr(jw, n), n
    for sym in ["Escape", "Left", "Up", "Right", "Down", "Prior", "Next", "a", "Z", "F13", "1"]:
        assert PORT_S.tkclient._keycode_of_keysym(sym) == JAX_S.tkclient._keycode_of_keysym(sym)


@pytest.mark.parametrize("seed", range(4))
def test_remote_display_decodes_alike(seed):
    rng = np.random.default_rng(seed)
    heads = ["AppStart", "AppClose", "KeyDown", "KeyUp", "LeftDown", "LeftUp", "RightDown", "RightUp", "LeftDragging",
             "Button", "CloseWindow", "OpenFile", "PaintRect", "BlurSlider", "TransSlider", "Internal", "Other"]
    for head in heads:
        n = {"KeyDown": 2, "KeyUp": 2, "Button": 2, "CloseWindow": 1, "PaintRect": 5, "BlurSlider": 2,
             "TransSlider": 2, "AppStart": 0, "AppClose": 0}.get(head, 3)
        rest = [int(v) for v in rng.integers(0, 400, n)]
        if head == "OpenFile":
            rest = [b"some/file.pdf"]
        for h in (head, head.encode()):
            v = [h, *rest]
            assert PORT_S.window.RemoteDisplay._decode(v) == JAX_S.window.RemoteDisplay._decode(v)
    for v in (None, [], 7):
        assert PORT_S.window.RemoteDisplay._decode(v) == JAX_S.window.RemoteDisplay._decode(v)


def test_tkclient_ppm_bytes_equal():
    img = np.random.default_rng(5).integers(0, 256, (4, 7, 3), dtype=np.uint8)
    data = PORT_S.tkclient.ppm_bytes(img)
    assert data == JAX_S.tkclient.ppm_bytes(img)
    assert data.startswith(b"P6\n7 4\n255\n") and len(data) == 11 + 4 * 7 * 3


@pytest.mark.parametrize("server,client", [(JAX_S, PORT_S), (PORT_S, JAX_S), (PORT_S, PORT_S)],
                         ids=["jax-serves-port", "port-serves-jax", "port-serves-port"])
def test_talk_round_trip_over_a_socket(server, client):
    sconn, cconn = socket_pair(server, client)
    big = bytes(range(256)) * 1200  # larger than one recv
    cconn.send(["AppStart"])
    assert sconn.poll() == [b"AppStart"]
    assert sconn.poll(block=False) is None
    sconn.send(["RefreshWindow", 7, 0, 0, 320, 320, big])
    assert cconn.poll() == [b"RefreshWindow", 7, 0, 0, 320, 320, big]
    cconn.send([1, [2, None]])
    cconn.send(b"tail")
    assert sconn.poll() == [1, [2, None]] and sconn.poll() == b"tail"
    cconn.close()
    with pytest.raises(ConnectionError):
        sconn.poll()
    sconn.close()


def test_port_connection_sets_tcp_nodelay():
    import socket

    sconn, cconn = socket_pair(PORT_S, PORT_S)
    for conn in (sconn, cconn):
        assert conn.sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY) != 0
    sconn.close()
    cconn.close()


def test_port_findport_handshake(tmp_path):
    """The engine binds first and writes its port; the client finds it."""
    talk = PORT_S.talk
    fp = str(tmp_path / "findport")
    got = {}

    def engine():
        got["conn"] = talk.establish_connection(findport_file=fp)

    t = threading.Thread(target=engine)
    t.start()
    cconn = talk.connect_findport(fp, timeout_s=60.0)
    t.join(DEADLINE)
    assert not os.path.exists(fp)
    cconn.send(["AppStart"])
    assert got["conn"].poll() == [b"AppStart"]
    assert got["conn"].process is None
    cconn.close()
    got["conn"].close()
    with pytest.raises(TimeoutError):
        talk.connect_findport(str(tmp_path / "never"), timeout_s=0.2)


def display_script(display, log):
    """What an engine asks of its display, in a fixed order; every answer is
    logged."""
    log.append(("startup event", display.poll()))
    w = display.make_window("first", 64, 48, 1, 2, 3, 4, True)
    w2 = display.make_window("second", 30, 20, 0, 0, 0, 0, False)
    log.append(("windows", w, w2))
    log.append(("size", display.window_size(w), display.window_size(w2)))
    log.append(("scroll", display.window_scroll(w)))
    log.append(("screen", display.screen_size(), display.platform()))
    rgb = np.random.default_rng(6).integers(0, 256, (10, 12, 3), dtype=np.uint8)
    display.refresh_window(w, 5, 6, 12, 10, rgb.tobytes())
    display.refresh_window(w, 60, 44, 12, 10, rgb.tobytes())  # hangs over the window's edge
    display.refresh_window(99, 0, 0, 12, 10, rgb.tobytes())  # no such window
    display.set_status_bar(w, "status text")
    display.set_blurslider(w, 4)
    display.set_transslider(w2, 77)
    display.set_cachetext("cache text")
    display.capture_mouse(w)
    display.release_mouse(w)
    display.open_cachewindow()
    log.append(("mouse", display.mouse_now(w)))
    # The client's events come back in order, around the synchronous calls.
    for _ in range(5):
        log.append(("event", display.poll()))
    display.close_window(w2)
    log.append(("closed", display.window_size(w)))
    display.close_application()


def run_display_pair(server, client):
    sconn, cconn = socket_pair(server, client)
    log = []
    t, fail = in_thread(display_script, server.window.RemoteDisplay(sconn), log)
    c = client.client.HeadlessClient(cconn)
    c.mouse = (11, 22)
    c.app_start()
    c.send_event("KeyDown", 1, 27)
    c.send_event("Button", 3, 1)
    c.left_click(1, 8, 9)
    c.send_event("OpenFile", "a.pdf")
    while c.running and c.handle_one():
        pass
    t.join(DEADLINE)
    assert not fail, fail
    cconn.close()
    sconn.close()
    windows = {k: (w.name, w.width, w.height, w.status, w.blur, w.trans, w.image.copy()) for k, w in c.windows.items()}
    return log, windows, c.cachetext, c.mouse


@pytest.mark.parametrize("server,client", [(JAX_S, PORT_S), (PORT_S, JAX_S), (PORT_S, PORT_S)],
                         ids=["jax-serves-port", "port-serves-jax", "port-serves-port"])
def test_cross_package_display_session(server, client):
    """A RemoteDisplay of one package and a HeadlessClient of the other
    exchange make_window, refresh_window, state and events exactly as the
    JAX package's own pair does."""
    want = run_display_pair(JAX_S, JAX_S)
    got = run_display_pair(server, client)
    assert got[0] == want[0]
    assert got[2:] == want[2:]
    assert got[1].keys() == want[1].keys() == {1}
    for k in want[1]:
        assert got[1][k][:6] == want[1][k][:6]
        assert np.array_equal(got[1][k][6], want[1][k][6])
    name, width, height, status, blur, trans, image = got[1][1]
    assert (name, width, height, status, blur) == ("first", 64, 48, "status text", 4)
    assert image[6:16, 5:17].any() and image[44:, 60:].any()


def test_client_dumps_its_window(tmp_path):
    sconn, cconn = socket_pair(PORT_S, PORT_S)

    def serve(display):
        display.poll()
        w = display.make_window("w", 16, 8, 0, 0, 0, 0, True)
        display.refresh_window(w, 0, 0, 16, 8, bytes(range(128)) * 3)
        display.close_application()

    t, fail = in_thread(serve, PORT_S.window.RemoteDisplay(sconn))
    c = PORT_S.client.HeadlessClient(cconn)
    c.app_start()
    while c.running and c.handle_one():
        pass
    t.join(DEADLINE)
    assert not fail
    c.save_png(1, str(tmp_path / "w.png"))
    c.save_ppm(1, str(tmp_path / "w.ppm"))
    assert np.array_equal(JAX_S.png.read_png(str(tmp_path / "w.png")), c.windows[1].image)
    assert open(tmp_path / "w.ppm", "rb").read() == PORT_S.tkclient.ppm_bytes(c.windows[1].image)
    cconn.close()
    sconn.close()
