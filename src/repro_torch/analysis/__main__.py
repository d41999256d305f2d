import sys

from repro_torch.analysis.runner import main

sys.exit(main(sys.argv[1:]))
