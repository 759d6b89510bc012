"""Command-line tools of the port: ``render`` (the headless render CLI),
``viewer`` (the interactive web viewer) and ``synth_assets`` (a
synthetic asset tree for the glTF presets)."""
