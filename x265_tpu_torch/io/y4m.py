"""Y4M (YUV4MPEG2) reader/writer. A copy of x265_tpu/io/y4m.py.

Reference behavior: x265 source/input/y4m.cpp (header parse, frame
framing) and source/output/y4m.cpp. 8/10-bit 4:2:0.
"""

from __future__ import annotations

import numpy as np


class Y4MReader:
    def __init__(self, path: str) -> None:
        self.f = open(path, "rb")
        header = self.f.readline().decode("ascii")
        if not header.startswith("YUV4MPEG2"):
            raise ValueError("not a Y4M file")
        self.width = self.height = 0
        self.fps_num, self.fps_den = 25, 1
        self.bit_depth = 8
        self.csp = "420"
        for tok in header.split()[1:]:
            c, v = tok[0], tok[1:]
            if c == "W":
                self.width = int(v)
            elif c == "H":
                self.height = int(v)
            elif c == "F":
                num, den = v.split(":")
                self.fps_num, self.fps_den = int(num), int(den)
            elif c == "C":
                if v.startswith("420"):
                    self.csp = "420"
                    if "p10" in v:
                        self.bit_depth = 10
                    elif "p12" in v:
                        self.bit_depth = 12
                else:
                    raise ValueError(f"unsupported chroma sampling {v}")
        if not self.width or not self.height:
            raise ValueError("Y4M header missing size")
        self._fsize = self.width * self.height * 3 // 2
        self._dtype = np.uint8 if self.bit_depth == 8 else np.uint16
        if self.bit_depth > 8:
            self._fsize *= 2

    def read_frame(self):
        line = self.f.readline()
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise ValueError("bad frame marker")
        data = self.f.read(self._fsize)
        if len(data) < self._fsize:
            return None
        arr = np.frombuffer(data, dtype=self._dtype)
        w, h = self.width, self.height
        y = arr[:w * h].reshape(h, w)
        cb = arr[w * h:w * h + w * h // 4].reshape(h // 2, w // 2)
        cr = arr[w * h + w * h // 4:].reshape(h // 2, w // 2)
        return y, cb, cr

    def __iter__(self):
        while True:
            f = self.read_frame()
            if f is None:
                return
            yield f

    def close(self) -> None:
        self.f.close()


class Y4MWriter:
    def __init__(self, path: str, width: int, height: int, fps_num: int = 25,
                 fps_den: int = 1, bit_depth: int = 8) -> None:
        self.f = open(path, "wb")
        c = "420mpeg2" if bit_depth == 8 else f"420p{bit_depth}"
        self.f.write(f"YUV4MPEG2 W{width} H{height} F{fps_num}:{fps_den} "
                     f"Ip A0:0 C{c}\n".encode("ascii"))
        self.dtype = np.uint8 if bit_depth == 8 else np.uint16

    def write_frame(self, y: np.ndarray, cb: np.ndarray,
                    cr: np.ndarray) -> None:
        self.f.write(b"FRAME\n")
        for p in (y, cb, cr):
            self.f.write(np.ascontiguousarray(p, dtype=self.dtype).tobytes())

    def close(self) -> None:
        self.f.close()
