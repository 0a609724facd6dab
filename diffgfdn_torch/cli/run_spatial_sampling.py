"""CLI: train common-slopes spatial-sampling DNNs (port of ``cli/run_spatial_sampling.py``).

    python -m diffgfdn_torch.cli.run_spatial_sampling -c <config.yml | preset name> [--device cpu]

``-c`` takes a YAML file or the name of a spatial preset in
``config/presets.py`` (``spatial_directional_1000Hz``,
``spatial_directional_1000Hz_cnn``, ``spatial_omni_1000Hz``), which needs no
YAML parser. Trains one model per grid resolution on the spatial dataset at
``room_dataset_path``: the position MLPs on receiver batches, the floor-plan
CNN (``network_type: cnn``) on one full-grid batch per resolution; on CUDA
unless ``--device cpu`` is given. All-band inference to SOFA
(``--infer-dataset``) and BRIRs (``--return-brirs``) need
``inference/sofa.py`` and raise NotImplementedError (ROADMAP A13); serving
from Python is ``diffgfdn_torch.inference.get_ambisonic_rirs``.
"""

import argparse
import logging


def _load_config(spec: str):
    from ..config import load_and_validate_config, SPATIAL_PRESETS, spatial_preset_config
    from ..config.schema import SpatialSamplingConfig

    if spec in SPATIAL_PRESETS:
        return spatial_preset_config(spec)
    return load_and_validate_config(spec, SpatialSamplingConfig)


def main(argv=None) -> dict:
    """Parse ``argv`` and train; returns ``run_training_spatial_sampling``'s
    {resolution: (trainer, model)}."""
    parser = argparse.ArgumentParser(
        description="Common-slopes spatial-sampling training with the PyTorch port")
    parser.add_argument("-c", "--config", required=True,
                        help="YAML config path, or the name of a spatial preset")
    parser.add_argument("--infer-dataset", default=None,
                        help="run all-band inference on this dataset (not ported: ROADMAP A13)")
    parser.add_argument("--return-brirs", action="store_true",
                        help="return BRIRs from the inferred SRIRs (not ported: ROADMAP A13)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.infer_dataset is not None or args.return_brirs:
        raise NotImplementedError(
            "all-band inference to SOFA files or BRIRs needs inference/sofa.py, which is not "
            "ported yet (ROADMAP A13); serve with diffgfdn_torch.inference.get_ambisonic_rirs"
        )

    from ..training.spatial_trainer import run_training_spatial_sampling
    from ..utils.device import resolve_device

    device = resolve_device(args.device)  # raises before anything is written
    logging.basicConfig(level=logging.INFO)
    return run_training_spatial_sampling(_load_config(args.config), device=device)


if __name__ == "__main__":
    main()
