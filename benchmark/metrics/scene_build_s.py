"""scene_build_s: host seconds of scenes.build (glTF and PNG decode, the
atlas pack, _finish) in this run's set-up."""


def read(rec):
    return rec.get("scene_build_s")
