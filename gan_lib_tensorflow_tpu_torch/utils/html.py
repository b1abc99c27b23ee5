"""HTML gallery writer (port of ``gan_lib_tensorflow_tpu/utils/html.py``,
verbatim): pix2pix's ``index.html``, a table of name | input | output |
target rows."""

from __future__ import annotations

import os
from typing import Dict, List


def write_gallery(out_dir: str, rows: List[Dict[str, str]],
                  columns=("input", "output", "target")) -> str:
    """rows: [{'name': ..., 'input': relpath, 'output': relpath, ...}]"""
    path = os.path.join(out_dir, "index.html")
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        f.write("<html><body><table><tr><th>name</th>")
        for c in columns:
            f.write(f"<th>{c}</th>")
        f.write("</tr>\n")
        for r in rows:
            f.write(f"<tr><td>{r.get('name', '')}</td>")
            for c in columns:
                f.write(f'<td><img src="{r[c]}"></td>' if c in r else "<td></td>")
            f.write("</tr>\n")
        f.write("</table></body></html>\n")
    return path
