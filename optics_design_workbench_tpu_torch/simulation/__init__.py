from .runner import runSimulation, runAction, setupRandomSeed
from .lifecycle import Lifecycle, SimulationEnded
from .results_store import (SimulationResults, getResultsFolderPath,
                            generateSimulationFolderName, getLatestRunIndex,
                            chunkFiles)

