#!/usr/bin/env python
"""Pack an image directory / list file into RecordIO; the port's copy of
the reference's ``tools/im2rec.py``, with the same arguments and output:
its ``.lst``, ``.rec`` and ``.idx`` files are byte-equal to the
reference tool's on the same images.

Two modes, like the reference:

  # 1. make a list file (label = folder index)
  python -m tpu_mx_torch.tools.im2rec --list data/train data/images

  # 2. pack it (resize shorter side to 480, quality 95)
  python -m tpu_mx_torch.tools.im2rec --resize 480 data/train data/images

``--native`` packs with the port's parallel C++ packer
(``tpu_mx_torch.lib.recordio_cpp.native_im2rec``), the Python path with
``tpu_mx_torch.recordio`` and OpenCV.

.lst format: <index>\t<label>[\t<label>...]\t<relative-path>
"""
import argparse
import os
import sys


IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def make_list(prefix, root, args):
    entries = []
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    label_of = {c: i for i, c in enumerate(classes)}
    if classes:
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(IMG_EXTS):
                    entries.append((float(label_of[c]),
                                    os.path.join(c, fn)))
    else:  # flat dir: label 0
        for fn in sorted(os.listdir(root)):
            if fn.lower().endswith(IMG_EXTS):
                entries.append((0.0, fn))
    if args.shuffle:
        import random
        random.seed(args.seed)
        random.shuffle(entries)
    lst = prefix + ".lst"
    with open(lst, "w") as f:
        for i, (label, path) in enumerate(entries):
            f.write(f"{i}\t{label}\t{path}\n")
    print(f"wrote {lst}: {len(entries)} images, {len(classes)} classes")


def read_list(lst):
    with open(lst) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            yield int(parts[0]), [float(x) for x in parts[1:-1]], parts[-1]


def pack(prefix, root, args):
    import cv2
    import numpy as np
    from tpu_mx_torch import recordio

    lst = prefix + ".lst"
    if not os.path.exists(lst):
        sys.exit(f"{lst} not found — run --list first")
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    n = 0
    for idx, labels, rel in read_list(lst):
        img = cv2.imread(os.path.join(root, rel), cv2.IMREAD_COLOR)
        if img is None:
            print(f"skip unreadable {rel}", file=sys.stderr)
            continue
        if args.resize > 0:
            h, w = img.shape[:2]
            scale = args.resize / min(h, w)
            if scale < 1 or args.upscale:
                img = cv2.resize(img, (int(w * scale + 0.5),
                                       int(h * scale + 0.5)))
        label = labels[0] if len(labels) == 1 else np.array(labels,
                                                           np.float32)
        header = recordio.IRHeader(0, label, idx, 0)
        rec.write_idx(idx, recordio.pack_img(header, img,
                                             quality=args.quality,
                                             img_fmt=args.encoding))
        n += 1
    rec.close()
    print(f"wrote {prefix}.rec / {prefix}.idx: {n} records")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("prefix", help="output prefix (for .lst/.rec/.idx)")
    ap.add_argument("root", help="image root directory")
    ap.add_argument("--list", action="store_true",
                    help="make the .lst file instead of packing")
    ap.add_argument("--native", action="store_true",
                    help="pack with the parallel C++ packer "
                         "(native/tpumx_io.cpp tmx_im2rec; same output "
                         "bytes as the Python path)")
    ap.add_argument("--num-thread", type=int, default=4)
    ap.add_argument("--resize", type=int, default=0,
                    help="resize shorter side to this many pixels")
    ap.add_argument("--upscale", action="store_true")
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--encoding", default=".jpg", choices=[".jpg", ".png"])
    ap.add_argument("--shuffle", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.list:
        make_list(args.prefix, args.root, args)
    else:
        if args.native:
            from tpu_mx_torch.lib.recordio_cpp import native_im2rec
            if getattr(args, "encoding", ".jpg") not in (None, ".jpg"):
                print("warning: --native packs JPEG only; --encoding "
                      "ignored", file=sys.stderr)
            n = native_im2rec(args.prefix + ".lst", args.root, args.prefix,
                              resize=args.resize or 0,
                              quality=args.quality,
                              num_thread=args.num_thread,
                              upscale=getattr(args, "upscale", False))
            print(f"packed {n} records (native)")
        else:
            pack(args.prefix, args.root, args)


if __name__ == "__main__":
    main()
