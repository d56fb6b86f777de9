from .terrain import FlatTerrain, FourierTerrain, PlaneTerrain, Terrain
