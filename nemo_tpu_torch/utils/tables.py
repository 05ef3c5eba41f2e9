"""A small column-oriented table, standing in for astropy.table.Table.

The reference passes astropy Tables through every catalog routine
(``nemo/catalogs.py``).  This native replacement supports the subset the
pipeline needs: named numpy columns, row masking, sorting, vstack, FITS
binary-table and CSV I/O, and a ``meta`` dict.
"""

import numpy as np

from . import fits as nfits


class Table:
    """Ordered mapping of column name -> 1-d numpy array, equal lengths."""

    def __init__(self, columns=None, meta=None):
        self._cols = {}
        self.meta = dict(meta) if meta else {}
        if columns:
            for k, v in columns.items():
                self[k] = v

    # -- dict-ish interface -------------------------------------------------
    def keys(self):
        return list(self._cols.keys())

    def colnames(self):
        return self.keys()

    def __contains__(self, key):
        return key in self._cols

    def __len__(self):
        if not self._cols:
            return 0
        return len(next(iter(self._cols.values())))

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        if isinstance(key, (int, np.integer)):
            return {k: v[key] for k, v in self._cols.items()}
        # boolean mask / index array / slice -> new Table
        new = Table(meta=self.meta)
        for k, v in self._cols.items():
            new._cols[k] = v[key]
        return new

    def __setitem__(self, key, value):
        value = np.asarray(value)
        if value.ndim == 0:
            value = np.full(max(len(self), 1), value)
        if self._cols and len(value) != len(self):
            raise ValueError("Column %r length %d != table length %d"
                             % (key, len(value), len(self)))
        self._cols[key] = value

    def __delitem__(self, key):
        del self._cols[key]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def remove_column(self, key):
        del self._cols[key]

    def rename_column(self, old, new):
        self._cols = {new if k == old else k: v for k, v in self._cols.items()}

    def add_column(self, values, name=None):
        if name is None:
            raise ValueError("name required")
        self[name] = values

    def copy(self):
        new = Table(meta=self.meta)
        for k, v in self._cols.items():
            new._cols[k] = v.copy()
        return new

    def sort(self, keys):
        if isinstance(keys, str):
            keys = [keys]
        order = np.lexsort(tuple(self._cols[k] for k in reversed(keys)))
        for k in self._cols:
            self._cols[k] = self._cols[k][order]

    def as_dict(self):
        return dict(self._cols)

    def __repr__(self):
        return "<Table rows=%d cols=%s>" % (len(self), self.keys())

    # -- I/O -----------------------------------------------------------------
    def write(self, path, overwrite=True):
        path = str(path)
        if path.endswith(".csv"):
            self._write_csv(path)
        else:
            header = nfits.Header()
            for k, v in self.meta.items():
                try:
                    header[str(k).upper()[:8]] = v
                except Exception:
                    pass
            hdu = nfits.HDU(data=self.as_dict(), header=header)
            hdu.is_table = True
            nfits.write(path, [hdu], overwrite=overwrite)

    def _write_csv(self, path):
        # Tab-delimited, matching the reference's writeCatalog CSV behaviour
        # (``nemo/catalogs.py:515``).
        keys = self.keys()
        with open(path, "w") as f:
            f.write("\t".join(keys) + "\n")
            for i in range(len(self)):
                row = []
                for k in keys:
                    v = self._cols[k][i]
                    if isinstance(v, (float, np.floating)):
                        row.append(repr(float(v)))
                    else:
                        row.append(str(v))
                f.write("\t".join(row) + "\n")

    @classmethod
    def read(cls, path, ext=None):
        path = str(path)
        if path.endswith(".csv"):
            return cls._read_csv(path)
        cols, header = nfits.read_table(path, ext=ext)
        tab = cls(cols)
        for k, v in header.items():
            if k.startswith(("TTYPE", "TFORM", "NAXIS")) or k in (
                    "XTENSION", "BITPIX", "PCOUNT", "GCOUNT", "TFIELDS",
                    "EXTNAME"):
                continue
            tab.meta[k] = v
        return tab

    @classmethod
    def _read_csv(cls, path):
        with open(path) as f:
            first = f.readline().rstrip("\n")
            delim = "\t" if "\t" in first else ","
            keys = first.split(delim)
            rows = [line.rstrip("\n").split(delim) for line in f
                    if line.strip()]
        cols = {}
        for j, k in enumerate(keys):
            raw = [r[j] for r in rows]
            arr = None
            for conv in (np.int64, np.float64):
                try:
                    arr = np.array(raw, dtype=conv)
                    break
                except ValueError:
                    continue
            if arr is None:
                arr = np.array(raw)
            cols[k] = arr
        return cls(cols)


def vstack(tables):
    """Stack tables with identical (or unionable) columns."""
    tables = [t for t in tables if t is not None and len(t) > 0]
    if not tables:
        return Table()
    keys = []
    for t in tables:
        for k in t.keys():
            if k not in keys:
                keys.append(k)
    out = Table(meta=tables[0].meta)
    for k in keys:
        parts = []
        for t in tables:
            if k in t:
                parts.append(np.asarray(t[k]))
            else:
                ref = None
                for t2 in tables:
                    if k in t2:
                        ref = t2[k]
                        break
                fill = -99 if ref is None or ref.dtype.kind in "if" else ""
                parts.append(np.full(len(t), fill,
                                     dtype=ref.dtype if ref is not None else float))
        out._cols[k] = np.concatenate(parts)
    return out
