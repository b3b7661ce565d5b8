"""Tiny datasets in the real on-disk layouts of TAP-Vid (DAVIS and
Kinetics pickles), JHMDB and BADJA, and a small exported ResNet-18-d1
``.pth``, for the port's evaluation tests (tests/test_torch_port_eval_tasks.py,
tests/test_torch_port_eval_run_task.py); it holds no test itself.

Frames are smooth random textures that pan, so propagation has something
to follow; everything comes from a seeded numpy generator.
"""

import io
import json
import os
import pickle

import numpy as np


def texture(rng, h, w):
    """(h, w, 3) uint8 low-passed noise."""
    noise = rng.standard_normal((h, w, 3))
    f = np.fft.fft2(noise, axes=(0, 1))
    ky, kx = np.fft.fftfreq(h), np.fft.fftfreq(w)
    k2 = ky[:, None] ** 2 + kx[None, :] ** 2
    tex = np.real(np.fft.ifft2(f * np.exp(-k2 * 300.0)[..., None], axes=(0, 1)))
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    return (tex * 255).astype(np.uint8)


def panning_video(rng, T, h, w):
    """(T, h, w, 3) uint8: a texture panning by up to a pixel a frame, and
    the (T, 2) (x, y) offset of each frame."""
    margin = 2 * T
    tex = texture(rng, h + 2 * margin, w + 2 * margin)
    vel = rng.uniform(-1.0, 1.0, 2)
    off = np.round(np.arange(T)[:, None] * vel[None]).astype(int) + margin
    video = np.stack([tex[oy:oy + h, ox:ox + w] for ox, oy in off])
    return video, (off - off[0]).astype(np.float64)


def export_pth(path, size=(32, 32), seed=0):
    """A flax ResNet-18-d1 init exported as the reference .pth both
    harnesses read."""
    import jax
    import torch

    from fgvc_tpu.models.resnet import init_resnet_params, resnet18_d1
    from fgvc_tpu.models.torch_convert import export_resnet_state_dict

    variables = init_resnet_params(resnet18_d1(), jax.random.PRNGKey(seed), size)
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in export_resnet_state_dict(variables).items()}}, path)
    return str(path)


def tapvid_record(rng, T, h, w, n_tracks, jpeg=False):
    """One TAP-Vid video: tracks follow the pan, are occluded outside the
    frame, and a third of them is hidden until frame 3 or 6 or hides for a
    few frames, so 'first' and 'strided' queries start several groups."""
    video, off = panning_video(rng, T, h, w)
    p0 = rng.uniform(4, [w - 4, h - 4], (n_tracks, 2))
    pts = p0[:, None, :] - off[None]
    occ = (pts < 0).any(-1) | (pts[..., 0] > w - 1) | (pts[..., 1] > h - 1)
    q = max(n_tracks // 6, 1)
    occ[:q, :3] = True
    occ[q:2 * q, :6] = True
    occ[2 * q:3 * q, 4:7] = True
    pts /= np.array([w, h], np.float64)
    if jpeg:
        from PIL import Image

        frames = []
        for f in video:
            buf = io.BytesIO()
            Image.fromarray(f).save(buf, format="JPEG", quality=90)
            frames.append(buf.getvalue())
        video = frames
    return {"video": video, "points": pts.astype(np.float32), "occluded": occ}


def make_tapvid(root, seed, n_videos=1, T=8, size=(32, 32), n_tracks=6, jpeg=False,
                nested=False):
    """Per-video pickles; `nested` stores {video_name: record} as the
    Kinetics shards do."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_videos):
        rec = tapvid_record(rng, T, *size, n_tracks, jpeg=jpeg)
        with open(os.path.join(root, f"video_{i:02d}.pkl"), "wb") as f:
            pickle.dump({f"video_{i:02d}": rec} if nested else rec, f)
    return str(root)


def make_jhmdb(root, seed, videos=(("a", 5, 40, 56), ("b", 4, 40, 56))):
    """A JHMDB tree: <root>/videos/<name>/%05d.png, <root>/anno/<name>.mat
    with 1-based pos_img (2, 15, T) of joints that follow the pan,
    <root>/val_list.txt."""
    import cv2
    import scipy.io as sio

    rng = np.random.default_rng(seed)
    lines = []
    for name, T, h, w in videos:
        vdir = os.path.join(root, "videos", name)
        os.makedirs(vdir, exist_ok=True)
        os.makedirs(os.path.join(root, "anno"), exist_ok=True)
        video, off = panning_video(rng, T, h, w)
        for t, frame in enumerate(video):
            cv2.imwrite(os.path.join(vdir, f"{t:05d}.png"), frame[..., ::-1])
        # joints within 16 px of the centre: PCK's thresholds are a few pixels
        j0 = np.array([w / 2, h / 2]) + rng.uniform(-8, 8, (15, 2))
        pos = (j0[None] - off[:, None]).transpose(2, 1, 0)  # (2, 15, T)
        sio.savemat(os.path.join(root, "anno", f"{name}.mat"), {"pos_img": pos + 1})
        lines.append(f"anno/{name}.mat videos/{name}")
    with open(os.path.join(root, "val_list.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(root)


def palette_png(path, labels):
    """A palette PNG whose colour 1 has two non-zero channels (as DAVIS's
    (128, 128, 0) objects do)."""
    from PIL import Image

    im = Image.fromarray(labels.astype(np.uint8), mode="P")
    im.putpalette([0, 0, 0, 128, 128, 0, 0, 0, 128] + [0] * (256 * 3 - 9))
    im.save(path)


def make_badja(root, seed, animal="dog", T=6, h=48, w=72, every=2):
    """A BADJA tree: <root>/JPEGImages/Full-Resolution/<animal>/%05d.jpg,
    palette-PNG segmentations under Annotations/Full-Resolution (label 1 on
    the animal, label 2 on a second region), and joint_annotations/ with the
    animal's JSON (37 SMAL joints (y, x) on every `every`-th frame, from the
    first to the last frame) and a skipped extra_videos entry."""
    import cv2

    rng = np.random.default_rng(seed)
    jdir = os.path.join(root, "JPEGImages", "Full-Resolution", animal)
    adir = os.path.join(root, "Annotations", "Full-Resolution", animal)
    for d in (jdir, adir, os.path.join(root, "joint_annotations")):
        os.makedirs(d, exist_ok=True)
    video, off = panning_video(rng, T, h, w)
    yy, xx = np.mgrid[:h, :w]
    j0 = rng.uniform(6, [h - 6, w - 6], (37, 2))  # (y, x)
    entries = []
    for t in range(T):
        cv2.imwrite(os.path.join(jdir, f"{t:05d}.jpg"), video[t][..., ::-1])
        cy, cx = h / 2 - off[t, 1], w / 2 - off[t, 0]
        labels = (((yy - cy) / (h / 4)) ** 2 + ((xx - cx) / (w / 4)) ** 2 <= 1).astype(np.uint8)
        labels[: h // 6, : w // 6] = 2
        palette_png(os.path.join(adir, f"{t:05d}.png"), labels)
        if t % every == 0 or t == T - 1:
            joints = j0 - off[t, ::-1]
            entries.append({
                "image_path": f"badja/JPEGImages/Full-Resolution/{animal}/{t:05d}.jpg",
                "segmentation_path": f"badja/Annotations/Full-Resolution/{animal}/{t:05d}.png",
                "joints": joints.tolist(),
                "visibility": rng.integers(0, 2, 37).tolist(),
            })
    with open(os.path.join(root, "joint_annotations", f"{animal}.json"), "w") as f:
        json.dump(entries, f)
    extra = [dict(entries[0], segmentation_path="badja/extra_videos/x/00000.png")]
    with open(os.path.join(root, "joint_annotations", "extra.json"), "w") as f:
        json.dump(extra, f)
    return str(root)


def make_davis(root, seed, seqs=(("bear", 5, 40, 72), ("car", 4, 36, 64))):
    """A DAVIS-2017 tree: JPEG frames under JPEGImages/480p/<seq>, palette
    PNG annotations of two moving objects on every frame under
    Annotations/480p/<seq>, ImageSets/2017/val.txt."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "ImageSets", "2017"), exist_ok=True)
    with open(os.path.join(root, "ImageSets", "2017", "val.txt"), "w") as f:
        f.write("\n".join(name for name, *_ in seqs) + "\n")
    for name, T, h, w in seqs:
        jdir = os.path.join(root, "JPEGImages", "480p", name)
        adir = os.path.join(root, "Annotations", "480p", name)
        os.makedirs(jdir, exist_ok=True)
        os.makedirs(adir, exist_ok=True)
        video, off = panning_video(rng, T, h, w)
        yy, xx = np.mgrid[:h, :w]
        for t in range(T):
            labels = np.zeros((h, w), np.uint8)
            for k, (cy, cx) in enumerate(((h / 3, w / 3), (2 * h / 3, 2 * w / 3)), start=1):
                inside = ((yy - cy + off[t, 1] * k) / (h / 6)) ** 2 \
                    + ((xx - cx - off[t, 0]) / (w / 6)) ** 2 <= 1
                labels[inside] = k
            frame = video[t].copy()
            frame[labels > 0] //= 2
            Image.fromarray(frame).save(os.path.join(jdir, f"{t:05d}.jpg"), quality=95)
            palette_png(os.path.join(adir, f"{t:05d}.png"), labels)
    return str(root)
