"""YAML IO helpers (host-side, non-critical path).

Copy of :mod:`pdc_tpu.utils.yaml_io` with ``import yaml`` moved into the
functions, so that importing the port needs only torch and numpy. Uses the
C loader when available for speed, falling back to the pure-python one.
"""

import os


def _loader_dumper():
    import yaml

    return (getattr(yaml, "CSafeLoader", yaml.SafeLoader),
            getattr(yaml, "CSafeDumper", yaml.SafeDumper))


def load_yaml(filename):
    """Load a YAML file into a dict."""
    import yaml

    with open(filename, "r") as f:
        return yaml.load(f, Loader=_loader_dumper()[0])


def save_yaml(data, filename):
    """Save a dict to a YAML file, creating parent directories as needed."""
    import yaml

    parent = os.path.dirname(os.path.abspath(filename))
    os.makedirs(parent, exist_ok=True)
    with open(filename, "w") as f:
        yaml.dump(data, f, Dumper=_loader_dumper()[1], default_flow_style=False)


def load_yaml_string(s):
    import yaml

    return yaml.load(s, Loader=_loader_dumper()[0])
