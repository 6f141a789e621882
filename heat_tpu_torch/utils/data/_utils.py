"""Standalone data-preparation utilities (counterpart of
heat_tpu/utils/data/_utils.py; reference: heat/utils/data/_utils.py).

The reference ships two untested, unsupported helpers for preparing ImageNet
TFRecord data (its own docstring: "not tested, nor actively supported").
They are kept for API parity:

* :func:`dali_tfrecord2idx` — pure-Python TFRecord framing walk; no external
  dependency, fully functional.
* :func:`merge_files_imagenet_tfrecord` — requires ``tensorflow`` + ``h5py``
  to decode tf.Example protos, neither of which is a dependency of this
  framework; the function gates on them at call time exactly like the
  reference (which imports tensorflow inside the function body).
"""

import os
import struct

__all__ = ["dali_tfrecord2idx", "merge_files_imagenet_tfrecord"]


def dali_tfrecord2idx(train_dir, train_idx_dir, val_dir, val_idx_dir):
    """Write DALI-style index files (``offset size`` per record) for every
    TFRecord file in ``train_dir`` and ``val_dir``
    (reference: _utils.py:13-44).

    TFRecord framing is ``uint64 length | uint32 crc | payload | uint32 crc``;
    the index records each record's byte offset and total framed size.
    """
    for src_dir, idx_dir in ((train_dir, train_idx_dir), (val_dir, val_idx_dir)):
        for name in os.listdir(src_dir):
            src = os.path.join(src_dir, name)
            if not os.path.isfile(src):
                continue
            fsize = os.path.getsize(src)
            with open(src, "rb") as f, open(os.path.join(idx_dir, name), "w") as idx:
                while True:
                    start = f.tell()
                    header = f.read(8)
                    if len(header) < 8:
                        break
                    (length,) = struct.unpack("<Q", header)
                    end = start + 8 + 4 + length + 4  # header, crc, payload, crc
                    if end > fsize:
                        # corrupt length or truncated final record: stop
                        # rather than index bytes that do not exist
                        break
                    f.seek(end)
                    idx.write(f"{start} {end - start}\n")


def merge_files_imagenet_tfrecord(folder_name, output_folder=None):
    """Merge preprocessed ImageNet TFRecord shards into the two HDF5 files
    (``imagenet_merged.h5`` / ``imagenet_merged_validation.h5``) expected by
    :class:`~heat_tpu_torch.utils.data.partial_dataset.PartialH5Dataset`
    (reference: _utils.py:47-236).

    Requires ``tensorflow`` (tf.Example decoding) and ``h5py``; both are
    probed at call time, mirroring the reference's in-function import.
    """
    try:
        import h5py  # noqa: F401
        import tensorflow as tf  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "merge_files_imagenet_tfrecord needs tensorflow and h5py, which "
            "are not dependencies of heat_tpu_torch; install them to run this "
            "one-off data-preparation step"
        ) from e

    output_folder = output_folder or "./"
    names = sorted(os.listdir(folder_name))
    splits = {
        "imagenet_merged.h5": [n for n in names if n.startswith("train")],
        "imagenet_merged_validation.h5": [n for n in names if n.startswith("val")],
    }
    for out_name, shard_names in splits.items():
        out_path = os.path.join(output_folder, out_name)
        images, meta, file_info = [], [], []
        for shard in shard_names:
            for raw in tf.data.TFRecordDataset(os.path.join(folder_name, shard)):
                ex = tf.train.Example()
                ex.ParseFromString(raw.numpy())
                feat = ex.features.feature
                images.append(feat["image/encoded"].bytes_list.value[0])
                meta.append(
                    [
                        feat["image/height"].int64_list.value[0],
                        feat["image/width"].int64_list.value[0],
                        feat["image/channels"].int64_list.value[0],
                        feat["image/class/label"].int64_list.value[0],
                    ]
                )
                file_info.append(
                    [
                        feat["image/format"].bytes_list.value[0],
                        feat["image/filename"].bytes_list.value[0],
                        feat["image/class/synset"].bytes_list.value[0],
                        feat["image/class/text"].bytes_list.value[0],
                    ]
                )
        with h5py.File(out_path, "w") as f:
            dt = h5py.special_dtype(vlen=bytes)
            f.create_dataset("images", data=images, dtype=dt)
            f.create_dataset("metadata", data=meta)
            f.create_dataset("file_info", data=file_info, dtype=dt)
