"""build_s: host seconds of SceneDatabase.build() (BLAS, threading, the
device flatten and upload), ending in a synchronize."""


def read(data):
    return data.build_s
