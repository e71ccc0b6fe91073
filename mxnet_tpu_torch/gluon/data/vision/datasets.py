"""Vision datasets (counterpart of `mxnet_tpu/gluon/data/vision/datasets.py`;
reference: python/mxnet/gluon/data/vision/datasets.py — MNIST :33,
FashionMNIST, CIFAR10 :110, CIFAR100, ImageRecordDataset,
ImageFolderDataset).

Datasets read local files only, in the reference's formats, from ``root``;
nothing is fetched and nothing is written: a missing file raises
`MXNetError` naming it. Samples are NDArrays on `current_context` (host
tensors in a DataLoader worker, which runs under a CPU scope)."""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as _np

from ....base import MXNetError
from ....ndarray import array
from ..dataset import Dataset, RecordFileDataset


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        self._get_data()

    def __getitem__(self, idx):
        # payloads are held as numpy and wrapped a sample at a time
        data = self._data[idx]
        data = array(data, dtype=str(data.dtype))
        if self._transform is not None:
            return self._transform(data, self._label[idx])
        return data, self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST (reference: datasets.py:33). Reads the standard idx-ubyte files
    (optionally gzipped) from root."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        self._train_data = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
        self._test_data = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
        super().__init__(root, transform)

    def _read_file(self, name):
        path = os.path.join(self._root, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return f.read()
        if os.path.exists(path + ".gz"):
            with gzip.open(path + ".gz", "rb") as f:
                return f.read()
        raise MXNetError(
            "MNIST file %s not found under %s (nothing is downloaded; place "
            "the standard idx files there)" % (name, self._root))

    def _get_data(self):
        images, labels = self._train_data if self._train else self._test_data
        raw = self._read_file(labels)
        magic, num = struct.unpack(">II", raw[:8])
        label = _np.frombuffer(raw[8:], dtype=_np.uint8).astype(_np.int32)
        raw = self._read_file(images)
        magic, num, rows, cols = struct.unpack(">IIII", raw[:16])
        data = _np.frombuffer(raw[16:], dtype=_np.uint8).reshape(num, rows, cols, 1)
        self._data = data  # numpy uint8 (host)
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from the python-pickle batches (reference: datasets.py:110)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None, fine_label=False):
        self._train = train
        self._fine = fine_label
        super().__init__(root, transform)

    def _batches(self):
        if self._train:
            return ["data_batch_%d" % i for i in range(1, 6)]
        return ["test_batch"]

    def _load_batch(self, name):
        for cand in (os.path.join(self._root, name),
                     os.path.join(self._root, "cifar-10-batches-py", name)):
            if os.path.exists(cand):
                with open(cand, "rb") as f:
                    d = pickle.load(f, encoding="latin1")
                return d
        tar = os.path.join(self._root, "cifar-10-python.tar.gz")
        if os.path.exists(tar):
            with tarfile.open(tar) as t:
                member = t.getmember("cifar-10-batches-py/" + name)
                d = pickle.load(t.extractfile(member), encoding="latin1")
            return d
        raise MXNetError("CIFAR batch %s not found under %s (nothing is "
                         "downloaded; place the python batches or "
                         "cifar-10-python.tar.gz there)" % (name, self._root))

    def _get_data(self):
        data, labels = [], []
        for name in self._batches():
            d = self._load_batch(name)
            data.append(d["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            labels.append(_np.asarray(d["labels" if "labels" in d else "fine_labels"]))
        self._data = _np.concatenate(data)  # numpy uint8 (host)
        self._label = _np.concatenate(labels).astype(_np.int32)


class CIFAR100(CIFAR10):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=False, train=True, transform=None):
        super().__init__(root, train, transform, fine_label)

    def _batches(self):
        return ["train"] if self._train else ["test"]


class ImageRecordDataset(RecordFileDataset):
    """Images packed in a RecordIO file (reference: datasets.py
    ImageRecordDataset; format from tools/im2rec)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import recordio, image

        record = super().__getitem__(idx)
        header, img = recordio.unpack(record)
        img = image.imdecode(img, self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """Images arranged in class folders (reference: datasets.py
    ImageFolderDataset)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        if not os.path.isdir(self._root):
            raise MXNetError("image folder %s not found" % self._root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".bmp"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from .... import image

        with open(self.items[idx][0], "rb") as f:
            img = image.imdecode(f.read(), self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
