"""Raw YUV (planar 4:2:0) reader, a copy of x265_tpu/io/yuv.py.
Reference: x265 source/input/yuv.cpp."""

from __future__ import annotations

import os

import numpy as np


class YUVReader:
    def __init__(self, path: str, width: int, height: int,
                 bit_depth: int = 8) -> None:
        self.f = open(path, "rb")
        self.width, self.height = width, height
        self.bit_depth = bit_depth
        self._dtype = np.uint8 if bit_depth == 8 else np.uint16
        self._fsize = width * height * 3 // 2 * (2 if bit_depth > 8 else 1)
        self.frame_count = os.path.getsize(path) // self._fsize

    def read_frame(self):
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
