"""Minimal pure-python bigfile reader/writer.

The port's own copy of ``pmesh_tpu/utils/bigfile.py`` (numpy only), so
that ``pmesh_tpu_torch`` imports nothing of the JAX package.

The reference ecosystem stores snapshots and Gadget/N-GenIC initial
conditions in the bigfile container (reference nbody/gravpm.py:23-31
writes them via `bigfile.mpi_create_from_data`, 89-109 reads them;
`debug-32/IC` is such a snapshot).  The format (reverse-engineered
from the reference fixture and validated against it byte-for-byte):

- a block is a directory with a text ``header``::

      DTYPE: <f8          (numpy dtype string)
      NMEMB: 3            (columns per row; 0 = scalar rows)
      NFILE: 1
      000000: 32768 : 73266133 : 63538

  one line per data file ``%06X``: rows, byte-sum (mod 2^32), and
  the 16-bit-folded byte-sum ``s % 65536 + s // 65536``.
- data files are raw little-endian C-order bytes.
- a block's ``attr`` file is a sequence of binary records::

      <i4 nmemb> <i4 namelen> <8s dtype> <namelen s name> <data>

- the dataset root contains a ``header`` block (NMEMB 0, no data)
  carrying the global attributes.

This module is host-side IO (numpy in, numpy out); devices never see
it: move tensors to the host (``.cpu().numpy()``) before writing.  It
reads multi-file blocks; writing uses a single data file per block
(NFILE=1), which every bigfile reader accepts.
"""
import os
import struct

import numpy as np

__all__ = ["BigFile", "Block", "write_block", "read_block",
           "read_attrs", "write_attrs"]


def _fold16(s):
    s = int(s) % (2 ** 32)
    return s % 65536 + s // 65536


class Block(object):
    """One bigfile block (column)."""

    def __init__(self, path):
        self.path = path
        self.dtype = None
        self.nmemb = 0
        self.nfile = 0
        self.sizes = []
        header = os.path.join(path, 'header')
        with open(header) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                key, _, rest = line.partition(':')
                key = key.strip()
                rest = rest.strip()
                if key == 'DTYPE':
                    self.dtype = np.dtype(rest)
                elif key == 'NMEMB':
                    self.nmemb = int(rest)
                elif key == 'NFILE':
                    self.nfile = int(rest)
                else:
                    parts = [p.strip() for p in rest.split(':')]
                    self.sizes.append((key, int(parts[0])))
        self.size = sum(n for _, n in self.sizes)

    def read(self, start=0, length=None):
        """rows [start, start+length) as a numpy array of shape
        (length,) (NMEMB<=1) or (length, NMEMB)."""
        if length is None:
            length = self.size - start
        nm = max(self.nmemb, 1)
        out = np.empty((length, nm), dtype=self.dtype)
        want_lo = start
        want_hi = start + length
        row0 = 0
        for fname, rows in self.sizes:
            lo = max(want_lo, row0)
            hi = min(want_hi, row0 + rows)
            if lo < hi:
                with open(os.path.join(self.path, fname), 'rb') as f:
                    f.seek((lo - row0) * nm * self.dtype.itemsize)
                    buf = f.read((hi - lo) * nm * self.dtype.itemsize)
                out[lo - start:hi - start] = np.frombuffer(
                    buf, dtype=self.dtype).reshape(hi - lo, nm)
            row0 += rows
        if self.nmemb <= 1:
            return out[:, 0]
        return out

    @property
    def attrs(self):
        return read_attrs(self.path)


class BigFile(object):
    """A bigfile dataset: a directory tree of blocks.

    >>> bf = BigFile('debug-32/IC')
    >>> pos = bf['1/Position'][...]        # or bf['1/Position'].read()
    >>> bf.attrs['BoxSize']
    """

    def __init__(self, path):
        self.path = path
        if not os.path.isdir(path):
            raise IOError("not a bigfile dataset: %s" % path)

    def __getitem__(self, name):
        return Block(os.path.join(self.path, name))

    def __contains__(self, name):
        return os.path.exists(
            os.path.join(self.path, name, 'header'))

    @property
    def blocks(self):
        out = []
        for root, dirs, files in os.walk(self.path):
            if 'header' in files:
                out.append(os.path.relpath(root, self.path))
        return sorted(out)

    @property
    def attrs(self):
        """attributes of the root 'header' block (Gadget convention),
        falling back to 'Header'."""
        for name in ('header', 'Header'):
            p = os.path.join(self.path, name)
            if os.path.isdir(p):
                return read_attrs(p)
        return {}


def read_attrs(blockpath):
    """the attr records of a block as a dict of numpy arrays."""
    out = {}
    path = os.path.join(blockpath, 'attr')
    if not os.path.exists(path):
        return out
    raw = open(path, 'rb').read()
    off = 0
    while off + 16 <= len(raw):
        nmemb, namelen = struct.unpack('<ii', raw[off:off + 8])
        dtype = np.dtype(raw[off + 8:off + 16].split(b'\0')[0]
                         .decode())
        off += 16
        name = raw[off:off + namelen].decode()
        off += namelen
        nbytes = nmemb * dtype.itemsize
        data = np.frombuffer(raw[off:off + nbytes], dtype=dtype)
        off += nbytes
        out[name] = data[0] if nmemb == 1 else data.copy()
    return out


def write_attrs(blockpath, attrs):
    """write a dict of scalars/arrays as a block's attr records."""
    chunks = []
    for name, value in attrs.items():
        arr = np.atleast_1d(np.asarray(value))
        dt = arr.dtype.str.encode()
        nameb = name.encode()
        chunks.append(struct.pack('<ii', arr.size, len(nameb)))
        chunks.append(dt + b'\0' * (8 - len(dt)))
        chunks.append(nameb)
        chunks.append(arr.tobytes())
    with open(os.path.join(blockpath, 'attr'), 'wb') as f:
        f.write(b''.join(chunks))


def write_block(root, name, data=None, attrs=None, dtype=None):
    """write one block (single data file).

    data : None (attribute-only block, e.g. 'header') or an (N,) /
    (N, nmemb) array.
    """
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    if data is None:
        with open(os.path.join(path, 'header'), 'w') as f:
            f.write("DTYPE: <i8\nNMEMB: 0\nNFILE: 0\n")
    else:
        data = np.asarray(data, dtype=dtype)
        if data.ndim == 1:
            nmemb = 1
        elif data.ndim == 2:
            nmemb = data.shape[1]
        else:
            raise ValueError("bigfile blocks are 1-d or 2-d")
        dt = data.dtype.newbyteorder('<')
        buf = np.ascontiguousarray(data, dtype=dt).tobytes()
        with open(os.path.join(path, '000000'), 'wb') as f:
            f.write(buf)
        s = int(np.frombuffer(buf, 'u1').sum()) % (2 ** 32)
        with open(os.path.join(path, 'header'), 'w') as f:
            f.write("DTYPE: %s\nNMEMB: %d\nNFILE: 1\n"
                    % (dt.str, nmemb))
            f.write("000000: %d : %d : %d\n"
                    % (len(data), s, _fold16(s)))
    if attrs:
        write_attrs(path, attrs)


def read_block(root, name):
    return Block(os.path.join(root, name)).read()
