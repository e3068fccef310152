"""All examples of all steps in the window over the host-clock seconds from
the window's start to its final synchronize."""


def read(record):
    window = record["window"]
    return window["steps"] * record["image_shape"][0] / window["seconds"] if window["steps"] else None
