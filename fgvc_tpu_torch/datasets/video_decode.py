"""Video-file loading stages of the port (fgvc_tpu/datasets/video_decode.py,
the mmaction-derived pipeline of loading.py) for the dict sample protocol.

The samplers draw from ``np.random.default_rng(seed)`` exactly as the JAX
package does.  Decoding runs on the host through the port's own video
reader (data_io/video.py: VP8, VP9 and Motion-JPEG in WebM/Matroska,
MPEG-4 Part 2 and Motion-JPEG in MP4/MOV and AVI, cv2.VideoCapture's pixels
bit for bit); other codecs raise ValueError naming the codec.  Frames come
out RGB (cv2's BGR with its channels reversed), resized where asked by
image_io.resize_frames (cv2.resize INTER_LINEAR bit for bit); raw frame
directories read through image_io.read_image (cv2.imread's pixels).
"""

from __future__ import annotations

import os.path as osp
from typing import Dict

import numpy as np

from fgvc_tpu_torch.data_io.video import VideoReader
from fgvc_tpu_torch.datasets.image_io import read_image, resize_frames


class SampleFrames:
    """Clip sampler (loading.py:81-260).

    Required keys: total_frames, start_index.  Adds: frame_inds, clip_len,
    frame_interval, num_clips.
    """

    def __init__(
        self,
        clip_len: int,
        frame_interval: int = 1,
        num_clips: int = 1,
        temporal_jitter: bool = False,
        twice_sample: bool = False,
        out_of_bound_opt: str = "loop",
        test_mode: bool = False,
        keep_tail_frames: bool = False,
        seed=None,
    ):
        assert out_of_bound_opt in ("loop", "repeat_last")
        self.clip_len = clip_len
        self.frame_interval = frame_interval
        self.num_clips = num_clips
        self.temporal_jitter = temporal_jitter
        self.twice_sample = twice_sample
        self.out_of_bound_opt = out_of_bound_opt
        self.test_mode = test_mode
        self.keep_tail_frames = keep_tail_frames
        self.rng = np.random.default_rng(seed)

    def _get_train_clips(self, num_frames: int) -> np.ndarray:
        ori_clip_len = self.clip_len * self.frame_interval
        if self.keep_tail_frames:
            avg = (num_frames - ori_clip_len + 1) / float(self.num_clips)
            if num_frames > ori_clip_len - 1:
                base = np.arange(self.num_clips) * avg
                return (base + self.rng.uniform(0, avg, self.num_clips)).astype(np.int64)
            return np.zeros((self.num_clips,), np.int64)
        avg = (num_frames - ori_clip_len + 1) // self.num_clips
        if avg > 0:
            base = np.arange(self.num_clips) * avg
            return base + self.rng.integers(0, avg, size=self.num_clips)
        if num_frames > max(self.num_clips, ori_clip_len):
            return np.sort(self.rng.integers(0, num_frames - ori_clip_len + 1,
                                             size=self.num_clips))
        if avg == 0:
            ratio = (num_frames - ori_clip_len + 1.0) / self.num_clips
            return np.around(np.arange(self.num_clips) * ratio).astype(np.int64)
        return np.zeros((self.num_clips,), np.int64)

    def _get_test_clips(self, num_frames: int) -> np.ndarray:
        ori_clip_len = self.clip_len * self.frame_interval
        avg = (num_frames - ori_clip_len + 1) / float(self.num_clips)
        if num_frames > ori_clip_len - 1:
            base = np.arange(self.num_clips) * avg
            offs = (base + avg / 2.0).astype(np.int64)
            if self.twice_sample:
                offs = np.concatenate([offs, base.astype(np.int64)])
            return offs
        return np.zeros((self.num_clips,), np.int64)

    def __call__(self, results: Dict) -> Dict:
        num_frames = results["total_frames"]
        offs = (self._get_test_clips(num_frames) if self.test_mode
                else self._get_train_clips(num_frames))
        inds = offs[:, None] + np.arange(self.clip_len)[None, :] * self.frame_interval
        inds = np.concatenate(inds)
        if self.temporal_jitter:
            inds = inds + self.rng.integers(0, self.frame_interval, size=len(inds))
        inds = inds.reshape((-1, self.clip_len))
        if self.out_of_bound_opt == "loop":
            inds = np.mod(inds, num_frames)
        else:  # repeat_last
            safe = inds < num_frames
            inds = np.where(safe, inds, np.max(np.where(safe, inds, 0), axis=1, keepdims=True))
        start = results.get("start_index", 0)
        results["frame_inds"] = np.concatenate(inds) + start
        results["clip_len"] = self.clip_len
        results["frame_interval"] = self.frame_interval
        results["num_clips"] = self.num_clips
        return results


class UntrimmedSampleFrames:
    """Fixed-interval clip centres over an untrimmed video
    (loading.py:261-313).  Required keys: total_frames.  Adds: frame_inds
    (clipped to range), clip_len, frame_interval, num_clips."""

    def __init__(self, clip_len: int = 1, frame_interval: int = 16):
        self.clip_len = clip_len
        self.frame_interval = frame_interval

    def __call__(self, results: Dict) -> Dict:
        total = results["total_frames"]
        centers = np.arange(self.frame_interval // 2, total, self.frame_interval)
        half = self.clip_len // 2
        inds = centers[:, None] + np.arange(-half, self.clip_len - half)
        inds = np.clip(inds, 0, total - 1)
        results["frame_inds"] = (np.concatenate(inds)
                                 + results.get("start_index", 0)).astype(np.int64)
        results["clip_len"] = self.clip_len
        results["frame_interval"] = self.frame_interval
        results["num_clips"] = len(centers)
        return results


class DenseSampleFrames(SampleFrames):
    """Dense sampling in a fixed window (loading.py:317-380): train picks
    one random window start, test spreads num_sample_positions starts
    evenly over [0, num_frames - sample_range].  Clip offsets step by
    sample_range // num_clips from each start, modulo num_frames.

    The reference's train draw has an EXCLUSIVE high of sample_position - 1
    (`np.random.randint(0, sample_position - 1)`, loading.py:360), so the
    last valid window start is never sampled; kept as the JAX package
    keeps it."""

    def __init__(self, *args, sample_range: int = 64, num_sample_positions: int = 10,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.sample_range = sample_range
        self.num_sample_positions = num_sample_positions

    def _get_train_clips(self, num_frames: int) -> np.ndarray:
        sample_position = max(1, 1 + num_frames - self.sample_range)
        interval = self.sample_range // self.num_clips
        start = 0 if sample_position == 1 else int(self.rng.integers(0, sample_position - 1))
        base = np.arange(self.num_clips) * interval
        return (base + start) % num_frames

    def _get_test_clips(self, num_frames: int) -> np.ndarray:
        sample_position = max(1, 1 + num_frames - self.sample_range)
        interval = self.sample_range // self.num_clips
        starts = np.linspace(0, sample_position - 1, num=self.num_sample_positions, dtype=int)
        base = np.arange(self.num_clips) * interval
        return np.concatenate([(base + s) % num_frames for s in starts])


class VideoDecode:
    """Video-file decoder (the OpenCV/Decord decode stages,
    loading.py:900-1070).  Required keys: filename, frame_inds.  Adds: imgs
    (list of HWC RGB uint8), original_shape, img_shape.

    Frames decode in order up to the largest index needed.  Indices past
    the decodable frames follow `out_of_range`: 'repeat_last' gives the last
    decoded frame (the reference OpenCVDecode's walk back,
    loading.py:1147-1152), 'error' raises IOError."""

    def __init__(self, out_of_range: str = "repeat_last"):
        assert out_of_range in ("repeat_last", "error")
        self.out_of_range = out_of_range

    def __call__(self, results: Dict) -> Dict:
        inds = np.asarray(results["frame_inds"]).ravel()
        need = set(int(i) for i in inds)
        last = max(need)
        frames = {}
        last_decoded = None
        with VideoReader(results["filename"]) as reader:
            for pos in range(last + 1):
                bgr = reader.read()
                if bgr is None:
                    break
                last_decoded = bgr[..., ::-1]
                if pos in need:
                    frames[pos] = last_decoded
        missing = need - frames.keys()
        if missing:
            if self.out_of_range == "error" or last_decoded is None:
                raise IOError(f"failed to decode frames {sorted(missing)} of "
                              f"{results['filename']}")
            for i in missing:
                frames[i] = last_decoded
        results["imgs"] = [np.ascontiguousarray(frames[int(i)]) for i in inds]
        results["original_shape"] = results["imgs"][0].shape[:2]
        results["img_shape"] = results["imgs"][0].shape[:2]
        return results


def decode_video(path: str, resize=None) -> np.ndarray:
    """Every decodable frame of a video file -> (T, H, W, 3) uint8 RGB, one
    native frame in flight: `resize=(w, h)` applies to each frame as it is
    decoded (image_io.resize_frames).  The decodable count is what counts,
    not the container's."""
    frames = []
    with VideoReader(path) as reader:
        for bgr in reader:
            rgb = np.ascontiguousarray(bgr[..., ::-1])
            if resize is not None:
                rgb = resize_frames(rgb[None], (resize[1], resize[0]))[0]
            frames.append(rgb)
    if not frames:
        raise IOError(f"no decodable frames in {path}")
    return np.stack(frames)


class VideoInit:
    """Probe a video file for total_frames (the *Init stages of loading.py):
    the container's count as cv2 reports it, counted by decoding where that
    is not positive."""

    def __call__(self, results: Dict) -> Dict:
        with VideoReader(results["filename"]) as reader:
            n = reader.frame_count
            if n <= 0:
                n = sum(1 for _ in reader)
        results["total_frames"] = n
        results.setdefault("start_index", 0)
        return results


# reference pipeline configs name the decord/OpenCV stages; one pair serves
# every alias
DecordInit = VideoInit
OpenCVInit = VideoInit
DecordDecode = VideoDecode
OpenCVDecode = VideoDecode


class RawFrameDecode:
    """Frame-directory reader (loading.py:1171): filename_tmpl % idx under
    results['frame_dir'], RGB output."""

    def __init__(self, filename_tmpl: str = "img_{:05}.jpg"):
        self.filename_tmpl = filename_tmpl

    def __call__(self, results: Dict) -> Dict:
        inds = np.asarray(results["frame_inds"]).ravel()
        imgs = []
        for i in inds:
            path = osp.join(results["frame_dir"], self.filename_tmpl.format(int(i)))
            if not osp.exists(path):
                raise IOError(f"cannot read frame {path}")
            imgs.append(read_image(path))
        results["imgs"] = imgs
        results["original_shape"] = imgs[0].shape[:2]
        results["img_shape"] = imgs[0].shape[:2]
        return results
