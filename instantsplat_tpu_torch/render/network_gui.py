"""SIBR remote-viewer TCP protocol (live rendering into the GUI); a copy of
instantsplat_tpu/render/network_gui.py, which needs no JAX (socket, json
and numpy), whose `ViewRequest.camera(device)` builds the port's Camera.

Wire-compatible re-implementation of the reference
gaussian_renderer/network_gui.py:26-86 — the protocol the SIBR viewer
speaks: a 4-byte little-endian length + JSON request carrying resolution,
FoV, near/far, flags, and GL-convention view/projection matrices; the
server replies with raw HxWx3 uint8 bytes followed by a length-prefixed
verification string (the source path).

As in the reference, the viewer loop is DISABLED by default in training
(train.py:310 --disable_viewer default True; loop commented at
train.py:125-138); this module makes the capability available for
interactive inspection:

    gui = NetworkGUI()
    gui.init("127.0.0.1", 6009)
    ...inside a loop:
    req = gui.poll()
    if req is not None:
        img = render(params, req.camera(device), ...).render
        gui.send_image(img.cpu().numpy(), verify=source_path)

The GL-style matrices are converted to our (R, t, fx, fy) camera: the
reference stores transposed matrices and flips the y/z columns
(network_gui.py:73-76); we undo both to recover the COLMAP-convention w2c.
"""

from __future__ import annotations

import dataclasses
import json
import socket
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ViewRequest:
    width: int
    height: int
    fovx: float
    fovy: float
    znear: float
    zfar: float
    w2c: np.ndarray  # [4,4] COLMAP-convention world-to-camera
    do_training: bool
    keep_alive: bool
    scaling_modifier: float

    def camera(self, device="cuda"):
        """The requested view as the port's Camera on `device`."""
        from instantsplat_tpu_torch.models.camera import Camera, fov2focal

        return Camera.create(
            R=self.w2c[:3, :3], t=self.w2c[:3, 3],
            fx=fov2focal(self.fovx, self.width),
            fy=fov2focal(self.fovy, self.height),
            height=self.height, width=self.width, device=device,
        )


class NetworkGUI:
    def __init__(self):
        self.listener: Optional[socket.socket] = None
        self.conn: Optional[socket.socket] = None

    def init(self, host="127.0.0.1", port=6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)

    def try_connect(self):
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
        except (BlockingIOError, OSError):
            pass

    def _recv_exact(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def read(self):
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def poll(self) -> Optional[ViewRequest]:
        """Accept/receive one request if a viewer is connected."""
        if self.conn is None:
            self.try_connect()
        if self.conn is None:
            return None
        try:
            msg = self.read()
        except (ConnectionError, OSError):
            self.conn = None
            return None
        w, h = msg["resolution_x"], msg["resolution_y"]
        if w == 0 or h == 0:
            return None
        view = np.array(msg["view_matrix"]).reshape(4, 4)
        # undo the reference's GL column flips + transpose storage
        view[:, 1] = -view[:, 1]
        view[:, 2] = -view[:, 2]
        w2c = view.T  # stored transposed (scene/cameras.py convention)
        return ViewRequest(
            width=w, height=h,
            fovx=msg["fov_x"], fovy=msg["fov_y"],
            znear=msg["z_near"], zfar=msg["z_far"],
            w2c=w2c,
            do_training=bool(msg["train"]),
            keep_alive=bool(msg["keep_alive"]),
            scaling_modifier=msg["scaling_modifier"],
        )

    def send_image(self, img, verify=""):
        """img [H,W,3] float in [0,1] (or uint8) + verification string."""
        if self.conn is None:
            return
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
        try:
            self.conn.sendall(arr.tobytes())
            self.conn.sendall(len(verify).to_bytes(4, "little"))
            self.conn.sendall(verify.encode("ascii"))
        except OSError:
            self.conn = None

    def close(self):
        for s in (self.conn, self.listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self.conn = self.listener = None
