"""The port's own copy of `no_time_to_train_tpu/data/video_loader.py`, so that the
port imports nothing of the JAX package.

Video frame loading (reference sam2/utils/misc.py:110-253:
load_video_frames + AsyncVideoFrameLoader): frames from a directory of
JPEG/PNG files or a list of paths, square-resized to the model size, with an
optional background-thread async loader that overlaps decode with tracking.
"""
import os
import threading

import numpy as np

from no_time_to_train_tpu_torch.data.datasets import load_image

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def list_frame_paths(video_path):
    names = [f for f in os.listdir(video_path)
             if f.lower().endswith(IMG_EXTS)]
    try:
        names.sort(key=lambda n: int(os.path.splitext(n)[0]))
    except ValueError:
        names.sort()
    return [os.path.join(video_path, n) for n in names]


def load_video_frames(video_path=None, img_paths=None, image_size=1024,
                      async_loading_frames=False):
    """Returns (frames, video_height, video_width); frames is either a numpy
    array [T, S, S, 3] or an AsyncVideoFrameLoader behaving like one."""
    paths = img_paths if img_paths is not None else list_frame_paths(video_path)
    if not paths:
        raise RuntimeError(f"no frames found in {video_path}")
    first, oh, ow = load_image(paths[0], image_size=image_size)
    if async_loading_frames:
        return AsyncVideoFrameLoader(paths, image_size, first), oh, ow
    frames = np.empty((len(paths), image_size, image_size, 3), np.float32)
    frames[0] = first
    for i, p in enumerate(paths[1:], start=1):
        frames[i], _, _ = load_image(p, image_size=image_size)
    return frames, oh, ow


class AsyncVideoFrameLoader:
    """Loads frames in a daemon thread; indexing blocks until the frame is
    ready (reference misc.py:110-176)."""

    def __init__(self, img_paths, image_size, first_frame=None):
        self.img_paths = img_paths
        self.image_size = image_size
        self._frames = [None] * len(img_paths)
        self._cond = threading.Condition()
        self.exception = None
        if first_frame is not None:
            self._frames[0] = first_frame
        self._thread = threading.Thread(target=self._load_all, daemon=True)
        self._thread.start()

    def _load_all(self):
        try:
            for i, p in enumerate(self.img_paths):
                if self._frames[i] is None:
                    frame, _, _ = load_image(p, image_size=self.image_size)
                    with self._cond:
                        self._frames[i] = frame
                        self._cond.notify_all()
                else:
                    with self._cond:
                        self._cond.notify_all()
        except Exception as e:  # surfaced on next access
            with self._cond:
                self.exception = e
                self._cond.notify_all()

    def __len__(self):
        return len(self.img_paths)

    def __getitem__(self, index):
        with self._cond:
            while self._frames[index] is None and self.exception is None:
                self._cond.wait()
            if self.exception is not None:
                raise self.exception
            return self._frames[index]

    @property
    def shape(self):
        return (len(self), self.image_size, self.image_size, 3)
