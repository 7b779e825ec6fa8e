"""Seeded CL007: broad except outside the allow-listed containment
seams, with no `# noqa: BLE001` tag."""


def load_manifest(path):
    try:
        return path.read_text()
    except Exception:   # CL007
        return None
