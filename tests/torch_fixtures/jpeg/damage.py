"""The byte edits that damage a JPEG frame, as manifest.json's "damaged"
sets list them: ["insert", offset, hex bytes], ["xor", offset, mask],
["cut", length], applied in order to the committed file named as the
frame's "source". make_fixtures.py writes the sets and the SHA-256 of
cv2.imread's planes of every damaged frame; the port's tests and
chip_smoke.py part 7g apply the same edits (the card's host has no cv2).
"""

import os


def damage(raw: bytes, edits) -> bytes:
    """`raw` with `edits` applied in order."""
    b = bytearray(raw)
    for op, *args in edits:
        if op == "cut":
            del b[args[0]:]
        elif op == "xor":
            b[args[0]] ^= args[1]
        elif op == "insert":
            b[args[0]:args[0]] = bytes.fromhex(args[1])
        else:
            raise ValueError(f"unknown edit {op!r}")
    return bytes(b)


def write_sets(root: str, fixtures: str, sets: dict) -> dict:
    """Every set of `sets` (name -> [{"name", "source", "edits"}]) written
    under root/name from the files under `fixtures`; {name: [paths]}."""
    out = {}
    for name, frames in sets.items():
        os.makedirs(os.path.join(root, name), exist_ok=True)
        out[name] = []
        for fr in frames:
            with open(os.path.join(fixtures, fr["source"]), "rb") as f:
                raw = damage(f.read(), fr["edits"])
            path = os.path.join(root, name, fr["name"])
            with open(path, "wb") as f:
                f.write(raw)
            out[name].append(path)
    return out
