#!/usr/bin/env python
"""nemoMock (PyTorch port): generate mock cluster catalogs from a selFn
directory.

Same flags as ``nemo_tpu.cli.nemoMock_main``, plus ``--device``: the mass
function's Boltzmann transfer is solved on that device (the
``boltzmann_rk4`` kernel on the card); the draws are host numpy, seeded
with ``-s``.

    python -m nemo_tpu_torch.cli.nemoMock_main selFn/ mocks/ -N 3 -s 1
"""

import argparse
import os


def makeParser():
    parser = argparse.ArgumentParser("nemoMock")
    parser.add_argument("selFnDir", help="Path to a selFn/ directory from a "
                                         "nemo run.")
    parser.add_argument("mocksDir", help="Output directory for mocks.")
    parser.add_argument("-c", "--config", dest="configFileName",
                        default=None,
                        help="Config file (default: selFnDir/config.yml).")
    parser.add_argument("-N", "--number-of-mocks", dest="numMocks", type=int,
                        default=1)
    parser.add_argument("-C", "--combine-mocks", dest="combineMocks",
                        action="store_true", default=False)
    parser.add_argument("-Q", "--Q-source", dest="QSource", default="fit")
    parser.add_argument("-S", "--SNR-cut", dest="SNRCut", type=float,
                        default=None,
                        help="Apply this fixed_SNR cut to the mocks.")
    parser.add_argument("-s", "--seed", dest="seed", type=int, default=None)
    parser.add_argument("--device", dest="device", default="cuda",
                        choices=("cuda", "cpu"),
                        help="Device to run on (default cuda; fails if no "
                             "CUDA device is present).")
    return parser


def main(argv=None):
    args = makeParser().parse_args(argv)
    from nemo_tpu_torch import pipelines, startup

    configFileName = args.configFileName or \
        os.path.join(args.selFnDir, "config.yml")
    config = startup.NemoConfig(configFileName, makeOutputDirs=False,
                                setUpMaps=False, verbose=False,
                                selFnDir=args.selFnDir, device=args.device)
    config.mocksDir = os.path.abspath(args.mocksDir)
    if args.seed is not None:
        config.parDict["seed"] = args.seed
    if args.SNRCut is not None:
        config.parDict["thresholdSigma"] = args.SNRCut
    pipelines.makeMockClusterCatalog(config, numMocksToMake=args.numMocks,
                                     combineMocks=args.combineMocks,
                                     QSource=args.QSource)
    print("... wrote mocks under %s" % config.mocksDir)


if __name__ == "__main__":
    main()
