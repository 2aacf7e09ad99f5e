"""Frequency- and time-domain beamforming.

Behavioral reference: `dsptoolbox/beamforming/beamforming.py`.

Device design: steering vectors are closed-form broadcasts; the DAS map — the
hottest loop in the reference (`beamforming.py:864-868`, grid×frequency
double loop of mic-space quadratic forms) — is one einsum
``map[g, f] = h*_fgm C_fmn h_fng``. MVDR uses a batched solve,
Functional a batched SVD, Orthogonal a batched eigendecomposition; CLEAN-SC
keeps its inherently sequential deconvolution loop with device quadratic
forms inside.
"""

from __future__ import annotations

from warnings import warn

import jax
import jax.numpy as jnp
import numpy as np

from ..classes import Signal
from ..helpers.gain_and_level import to_db
from ..helpers.other import (
    euclidean_distance_matrix,
    find_nearest_points_index_in_vector,
    fractional_octave_bandwidth,
)
from ..ops.pad_trim import pad_trim_axis
from ..plots import general_matrix_plot
from ..standard.appending import append_signals
from ..standard.latency_delay import fractional_delay
from ..standard.pad_trim_methods import pad_trim
from .enums import SteeringVectorType

nxs = np.newaxis
_HIGH = jax.lax.Precision.HIGHEST


class BasePoints:
    """Point-cloud container (grids, mic arrays;
    `_beamforming.py:14-193`)."""

    def __init__(self, positions: dict):
        for i in ("x", "y", "z"):
            assert i in positions, f"{i} values are missing"
        x = np.asarray(positions["x"]).squeeze()[None, ...]
        y = np.asarray(positions["y"]).squeeze()[None, ...]
        z = np.asarray(positions["z"]).squeeze()[None, ...]
        assert x.shape == y.shape and x.shape == z.shape, (
            "Shapes of x, y or z are not compatible"
        )
        new_r = np.concatenate([x, y, z], axis=0)
        self.coordinates = new_r.T

    @property
    def number_of_points(self):
        return self.coordinates.shape[0]

    @property
    def coordinates(self) -> np.ndarray:
        return self._coordinates.copy()

    @coordinates.setter
    def coordinates(self, new_r):
        assert isinstance(new_r, np.ndarray), (
            "R vectors array should be of type numpy.ndarray"
        )
        ndimensions = 3
        dimensions = ["x", "y", "z"]
        base_dimensions = ["x", "y", "z"]
        for i in range(new_r.shape[1]):
            if len(np.unique(new_r[:, i])) == 1:
                ndimensions -= 1
                dimensions.remove(base_dimensions[i])
        self.dim = dimensions
        self.ndim = ndimensions
        self._coordinates = new_r

    @property
    def extent(self):
        extent = {}
        for i, d in enumerate(["x", "y", "z"]):
            extent[d] = [
                np.min(self.coordinates[:, i]),
                np.max(self.coordinates[:, i]),
            ]
        return extent

    def get_distances_to_point(self, point) -> np.ndarray:
        """Euclidean distances from all points to given point(s), host
        numpy (`helpers/other.py:131`): geometry is a few thousand
        points at most, and the callers consume numpy anyway."""
        point = np.asarray(point, np.float64)
        if point.ndim == 1:
            point = point[None, ...]
        assert point.shape[1] == self.coordinates.shape[1], (
            f"Invalid shapes: {point.shape}, {self.coordinates.shape}"
        )
        c = np.asarray(self.coordinates, np.float64)
        sq = (
            np.sum(c**2, axis=1, keepdims=True)
            + np.sum(point**2, axis=1)[None, :]
            - 2.0 * c @ point.T
        )
        return np.sqrt(np.clip(sq, 0.0, None)).squeeze()

    def plot_points(self, projection: str | None = None):
        from ..plots.plots import _plt

        plt = _plt()
        if projection is not None:
            projection = projection.lower()
        if self.ndim == 3 or projection == "3d":
            projection = "3d"
            threed = True
        elif projection in (None, "2d"):
            threed = False
            projection = None
        else:
            raise ValueError("projection must be 2d, 3d or None")
        fig, ax = plt.subplots(
            1, 1, figsize=(7, 5), subplot_kw={"projection": projection}
        )
        if threed:
            ax.scatter(
                xs=self.coordinates[:, 0],
                ys=self.coordinates[:, 1],
                zs=self.coordinates[:, 2],
            )
            ax.set_xlabel("$x$ / m")
            ax.set_ylabel("$y$ / m")
            ax.set_zlabel("$z$ / m")
        else:
            helper = dict(x=0, y=1, z=2)
            dim1 = helper[self.dim[0]]
            dim2 = dim1 - 1 if self.ndim == 1 else helper[self.dim[1]]
            ax.scatter(
                x=self.coordinates[:, dim1], y=self.coordinates[:, dim2]
            )
            ax.set_xlabel(f"${self.dim[0]}$ / m")
            ax.set_ylabel(f"${['x', 'y', 'z'][dim2]}$ / m")
        fig.tight_layout()
        return fig, ax

    def find_nearest_point(self, point):
        point = np.asarray(point).squeeze()
        assert point.ndim == 1, (
            "Passed vector is not broadcastable to a 1D-array"
        )
        assert len(point) == 3, (
            "Point must have exactly 3 dimensions (x, y, z)"
        )
        dist = self.get_distances_to_point(point)
        index = int(np.argmin(dist))
        return index, self.coordinates[index, :]


class Grid(BasePoints):
    """Beamforming grid (`beamforming.py:35-77`)."""

    def reconstruct_map_shape(self, map: np.ndarray) -> np.ndarray:
        return map


class Regular2DGrid(Grid):
    """Rectangular 2D grid on a coordinate plane
    (`beamforming.py:78-216`)."""

    def __init__(self, line1, line2, dimensions, value3):
        line1 = np.asarray(line1).squeeze()
        line2 = np.asarray(line2).squeeze()
        assert len(dimensions) == 2, "dimensions must have two entries"
        self.original_lengths = (len(line1), len(line2))
        self.dimensions_grid = tuple(dimensions)
        g1, g2 = np.meshgrid(line1, line2, indexing="ij")
        base = {"x": None, "y": None, "z": None}
        base[dimensions[0]] = g1.flatten()
        base[dimensions[1]] = g2.flatten()
        third = list(set(["x", "y", "z"]) - set(dimensions))[0]
        base[third] = np.ones(g1.size) * value3
        super().__init__(base)

    def reconstruct_map_shape(self, map_vector: np.ndarray) -> np.ndarray:
        assert map_vector.ndim == 1, (
            "The passed map should be a vector (flattened)"
        )
        assert len(map_vector) == self.number_of_points, (
            "Length of passed vector does not match the number of points"
        )
        return map_vector.reshape(self.original_lengths)

    def plot_map(self, map: np.ndarray, range_db: float = 20):
        if map.ndim == 1:
            map = self.reconstruct_map_shape(map)
        ex = self.extent
        map_db = np.asarray(to_db(jnp.asarray(map), False, 500))
        fig, ax = general_matrix_plot(
            map_db,
            range_x=ex[self.dimensions_grid[1]],
            range_y=ex[self.dimensions_grid[0]],
            range_z=range_db,
            xlabel=self.dimensions_grid[1] + " / m",
            ylabel=self.dimensions_grid[0] + " / m",
            zlabel="dBFS",
            colorbar=True,
            lower_origin=True,
        )
        return fig, ax


class Regular3DGrid(Grid):
    """Regular 3D grid (`beamforming.py:218-366`)."""

    def __init__(self, line_x, line_y, line_z):
        line_x = np.asarray(line_x).squeeze()
        line_y = np.asarray(line_y).squeeze()
        line_z = np.asarray(line_z).squeeze()
        self.lines = (line_x, line_y, line_z)
        assert all(n.ndim == 1 for n in self.lines), (
            "Shape of lines is invalid"
        )
        self.original_lengths = (len(line_x), len(line_y), len(line_z))
        xx, yy, zz = np.meshgrid(line_x, line_y, line_z, indexing="ij")
        super().__init__(
            {
                "x": xx.flatten(),
                "y": yy.flatten(),
                "z": zz.flatten(),
            }
        )

    def reconstruct_map_shape(self, map_vector: np.ndarray) -> np.ndarray:
        assert map_vector.ndim == 1, (
            "The passed map should be a vector (flattened)"
        )
        assert len(map_vector) == self.number_of_points, (
            "Length of passed vector does not match the number of points"
        )
        return map_vector.reshape(self.original_lengths)

    def plot_map(
        self,
        map: np.ndarray,
        third_dimension: str,
        value_third_dimension: float,
        range_db: float = 20,
    ):
        if map.ndim == 1 and len(map) == self.number_of_points:
            map = self.reconstruct_map_shape(map)
        assert map.shape == self.original_lengths, (
            "Map shape does not match grid shape"
        )
        if third_dimension == "x":
            ind = np.argmin(np.abs(value_third_dimension - self.lines[0]))
            map = map[ind, :, :]
            extent_dimensions = ["y", "z"]
        elif third_dimension == "y":
            ind = np.argmin(np.abs(value_third_dimension - self.lines[1]))
            map = map[:, ind, :]
            extent_dimensions = ["x", "z"]
        elif third_dimension == "z":
            ind = np.argmin(np.abs(value_third_dimension - self.lines[2]))
            map = map[:, :, ind]
            extent_dimensions = ["x", "y"]
        else:
            raise ValueError(f"{third_dimension} is not a valid dimension")
        ex = self.extent
        map_db = np.asarray(to_db(jnp.asarray(map), False, 500))
        return general_matrix_plot(
            map_db,
            range_x=ex[extent_dimensions[1]],
            range_y=ex[extent_dimensions[0]],
            range_z=range_db,
            xlabel=extent_dimensions[1] + " / m",
            ylabel=extent_dimensions[0] + " / m",
            zlabel="dBFS",
            colorbar=True,
            lower_origin=True,
        )


class LineGrid(Grid):
    """Line grid along a coordinate (`beamforming.py:368-424`)."""

    def __init__(self, line, dimension: str, value2: float, value3: float):
        line = np.atleast_1d(np.squeeze(line))
        assert line.ndim == 1, "Line has an invalid shape"
        dimension = dimension.lower()
        base_dimensions = ["x", "y", "z", "x"]
        assert dimension in base_dimensions, "Dimension should be x, y or z"
        ind = base_dimensions.index(dimension)
        base_dimensions.pop(ind)
        dim2 = base_dimensions[ind]
        dim3 = list(set(["x", "y", "z"]) - set([dimension, dim2]))[0]
        self.extent_dimension = dimension
        super().__init__(
            {
                dimension: line,
                dim2: np.ones(len(line)) * value2,
                dim3: np.ones(len(line)) * value3,
            }
        )


class MicArray(BasePoints):
    """Microphone array with aperture/frequency-range helpers
    (`beamforming.py:425-603`)."""

    def __init__(self, positions: dict):
        super().__init__(positions)
        self.__array_center_coordinates = None
        self.__array_center_channel_number = None
        self.__aperture = None
        self.__min_distance = None

    @staticmethod
    def from_xml(path: str) -> "MicArray":
        """Load an Acoular-style microphone-array geometry XML
        (``<pos x=".." y=".." z=".." />`` entries, like
        `example_data/array.xml`)."""
        import xml.etree.ElementTree as ET

        root = ET.parse(path).getroot()
        xs, ys, zs = [], [], []
        for pos in root.iter("pos"):
            xs.append(float(pos.attrib["x"]))
            ys.append(float(pos.attrib["y"]))
            zs.append(float(pos.attrib["z"]))
        assert xs, f"No <pos> entries found in {path}"
        return MicArray(
            dict(
                x=np.asarray(xs), y=np.asarray(ys), z=np.asarray(zs)
            )
        )

    @property
    def aperture(self):
        if self.__aperture is None:
            self.__compute_aperture_min_distance()
        return self.__aperture

    @property
    def min_distance(self):
        if self.__min_distance is None:
            self.__compute_aperture_min_distance()
        return self.__min_distance

    @property
    def array_center_coordinates(self):
        if self.__array_center_coordinates is None:
            self.__compute_array_center()
        return self.__array_center_coordinates

    @property
    def array_center_channel_number(self):
        if self.__array_center_channel_number is None:
            self.__compute_array_center()
        return self.__array_center_channel_number

    def __compute_aperture_min_distance(self):
        distances = self.get_distances_to_point(self.coordinates)
        np.fill_diagonal(distances, np.inf)
        self.__min_distance = np.min(distances)
        np.fill_diagonal(distances, -np.inf)
        self.__aperture = np.max(distances)

    def __compute_array_center(self):
        center = np.mean(self.coordinates, axis=0)
        distances = self.get_distances_to_point(center)
        ind = int(np.argmin(distances))
        self.__array_center_coordinates = self.coordinates[ind, :]
        self.__array_center_channel_number = ind

    def he_to_hz(self, he: float, c: float = 343) -> float:
        return he * c / self.aperture

    def hz_to_he(self, f_hz: float, c: float = 343) -> float:
        return f_hz * self.aperture / c

    def get_maximum_frequency_range(
        self, lowest_he: float = 4, c: float = 343
    ) -> list:
        return [self.he_to_hz(lowest_he, c=c), c / self.min_distance / 2]


# ========== Steering vector formulations ====================================
def classic_steering(wave_number, grid: Grid, mic: MicArray):
    """Sarradj formulation 1 (`beamforming.py:1515-1553`)."""
    wave_number = np.atleast_1d(wave_number)
    assert wave_number.ndim == 1, "Wave number should be a 1D-array"
    N = mic.number_of_points
    rt0 = grid.get_distances_to_point(mic.array_center_coordinates)
    rti = grid.get_distances_to_point(mic.coordinates).T
    k = np.asarray(wave_number)[:, nxs, nxs]
    diff = rti[nxs, :, :] - rt0[nxs, nxs, :]
    return 1 / N * np.exp(-1j * k * diff)


def inverse_steering(wave_number, grid: Grid, mic: MicArray):
    """Sarradj formulation 2 (`beamforming.py:1555-1598`)."""
    wave_number = np.atleast_1d(wave_number)
    assert wave_number.ndim == 1, "Wave number should be a 1D-array"
    N = mic.number_of_points
    rt0 = grid.get_distances_to_point(mic.array_center_coordinates)
    rti = grid.get_distances_to_point(mic.coordinates).T
    k = np.asarray(wave_number)[:, nxs, nxs]
    diff = rti[nxs, :, :] - rt0[nxs, nxs, :]
    amp = rti[nxs, :, :] / N / rt0[nxs, nxs, :]
    return amp * np.exp(-1j * k * diff)


def true_power_steering(wave_number, grid: Grid, mic: MicArray):
    """Sarradj formulation 3 (`beamforming.py:1600-1645`)."""
    wave_number = np.atleast_1d(wave_number)
    assert wave_number.ndim == 1, "Wave number should be a 1D-array"
    rt0 = grid.get_distances_to_point(mic.array_center_coordinates)
    rti = grid.get_distances_to_point(mic.coordinates).T
    rtj = np.sum(
        1 / mic.get_distances_to_point(grid.coordinates) ** 2, axis=0
    )
    k = np.asarray(wave_number)[:, nxs, nxs]
    diff = rti[nxs, :, :] - rt0[nxs, nxs, :]
    amp = 1 / rt0[nxs, nxs, :] / rti[nxs, :, :] / rtj[nxs, nxs, :]
    return amp * np.exp(-1j * k * diff)


def true_location_steering(wave_number, grid: Grid, mic: MicArray):
    """Sarradj formulation 4 (`beamforming.py:1647-1702`)."""
    wave_number = np.atleast_1d(wave_number)
    assert wave_number.ndim == 1, "Wave number should be a 1D-array"
    N = mic.number_of_points
    rt0 = grid.get_distances_to_point(mic.array_center_coordinates)
    rti = grid.get_distances_to_point(mic.coordinates).T
    rtj = N * np.sum(
        1 / mic.get_distances_to_point(grid.coordinates) ** 2, axis=0
    )
    k = np.asarray(wave_number)[:, nxs, nxs]
    diff = rti[nxs, :, :] - rt0[nxs, nxs, :]
    amp = 1 / rti[nxs, :, :] / np.sqrt(rtj)[nxs, nxs, :]
    return amp * np.exp(-1j * k * diff)


def _steering_amp_diff(formulation, grid: Grid, mic: MicArray):
    """Frequency-independent factorization of every Sarradj formulation:
    ``h[f, m, g] = amp[m, g] * exp(-1j * k[f] * diff[m, g])``. Shipping the
    small (M, G) factors to the device and building ``h`` in-program avoids
    uploading the full (F, M, G) complex tensor (~27 MB for 64 mics x 900
    grid points x 15 bins)."""
    N = mic.number_of_points
    rt0 = grid.get_distances_to_point(mic.array_center_coordinates)  # (G,)
    rti = grid.get_distances_to_point(mic.coordinates).T  # (M, G)
    diff = rti - rt0[nxs, :]
    if formulation == SteeringVectorType.Classic:
        amp = np.full(rti.shape, 1.0 / N)
    elif formulation == SteeringVectorType.Inverse:
        amp = rti / N / rt0[nxs, :]
    elif formulation == SteeringVectorType.TruePower:
        rtj = np.sum(
            1 / mic.get_distances_to_point(grid.coordinates) ** 2, axis=0
        )
        amp = 1 / rt0[nxs, :] / rti / rtj[nxs, :]
    elif formulation == SteeringVectorType.TrueLocation:
        rtj = N * np.sum(
            1 / mic.get_distances_to_point(grid.coordinates) ** 2, axis=0
        )
        amp = 1 / rti / np.sqrt(rtj)[nxs, :]
    else:
        raise ValueError("Unsupported steering formulation")
    return amp, diff


class SteeringVector:
    """Dispatch for the 4 Sarradj formulations
    (`beamforming.py:605-648`)."""

    def __init__(
        self,
        formulation: SteeringVectorType = SteeringVectorType.TrueLocation,
    ):
        mapping = {
            SteeringVectorType.Classic: classic_steering,
            SteeringVectorType.Inverse: inverse_steering,
            SteeringVectorType.TruePower: true_power_steering,
            SteeringVectorType.TrueLocation: true_location_steering,
        }
        if formulation not in mapping:
            raise ValueError(
                "Incorrect formulation. Use either classic, inverse, "
                "true power or true location"
            )
        self.formulation = formulation
        self.get_vector = mapping[formulation]

    def get_amp_diff(self, grid: Grid, mic: MicArray):
        """Frequency-independent ``(amp (M, G), diff (M, G))`` factors of
        this formulation (see `_steering_amp_diff`)."""
        return _steering_amp_diff(self.formulation, grid, mic)


def _simpson_uniform(y: np.ndarray, dx: float, axis: int = -1) -> np.ndarray:
    from scipy.integrate import simpson

    return simpson(y, dx=dx, axis=axis)


def _packed_quadratic_from_hp(hp, c_re, c_im):
    """``map[g, f] = p^T B p`` for a prebuilt packed steering factor
    ``hp (F, G, 2M) = [Re h | Im h]`` and split matrix ``C (F, M, M)``:
    with ``B = [[Cre, -Cim], [Cim, Cre]]``, ``Re(h^H C h) = p^T B p``
    exactly (no Hermitian assumption needed). Shared core of
    `_packed_quadratic_gf` and `_das_map_core` — one real contraction
    over 2M instead of a complex one over M, and the program is
    all-real."""
    B = jnp.concatenate(
        [
            jnp.concatenate([c_re, -c_im], axis=-1),
            jnp.concatenate([c_im, c_re], axis=-1),
        ],
        axis=-2,
    )  # (F, 2M, 2M)
    t = jnp.einsum("fgk,fkl->fgl", hp, B, precision=_HIGH)
    return jnp.einsum("fgl,fgl->gf", hp, t, precision=_HIGH)


def _packed_quadratic_gf(h_re, h_im, c_re, c_im):
    """``Re(h^H C h) -> (G, F)`` for explicit split steering ``h (F, M,
    G)`` and matrix ``C (F, M, M)`` in the packed-real block form (see
    `_packed_quadratic_from_hp`)."""
    hp = jnp.concatenate(
        [jnp.swapaxes(h_re, 1, 2), jnp.swapaxes(h_im, 1, 2)], axis=-1
    )  # (F, G, 2M)
    return _packed_quadratic_from_hp(hp, c_re, c_im)


def _das_map_core(ampj, diffj, kj, csm_re, csm_im):
    """DAS quadratic form with the steering tensor built on-device:
    ``h[f,m,g] = amp[m,g] e^{-j k_f diff[m,g]}``, ``map[g,f] = h^H C h``.

    Runs in packed-real block form: with ``p = [Re h; Im h]`` (2M) and
    ``B = [[Cre, -Cim], [Cim, Cre]]`` (2M, 2M), ``Re(h^H C h) = p^T B p``
    exactly (no Hermitian assumption needed). The contraction is one
    real product over 2M instead of a complex one over M, and the program
    is all-real — no complex boundary at all. cos and sin share one
    (F, G, M) phase tensor."""
    ph = kj[:, None, None] * diffj.T[None]  # (F, G, M)
    amp_t = ampj.T[None]
    hp = jnp.concatenate(
        [amp_t * jnp.cos(ph), -amp_t * jnp.sin(ph)], axis=-1
    )  # (F, G, 2M) = [Re h | Im h]
    return _packed_quadratic_from_hp(hp, csm_re, csm_im)


class BaseBeamformer:
    """Base beamformer (`beamforming.py:650-754`)."""

    def __init__(
        self, multi_channel_signal: Signal, mic_array: MicArray, c: float = 343
    ):
        assert isinstance(multi_channel_signal, Signal), (
            "Multi-channel signal must be of type Signal"
        )
        assert isinstance(mic_array, MicArray), (
            "mic_array should be of type MicArray"
        )
        assert c > 0, "Speed of sound should be bigger than 0"
        assert (
            multi_channel_signal.number_of_channels
            == mic_array.number_of_points
        ), "Number of channels in signal and microphone array do not match"
        self.signal = multi_channel_signal
        self.mics = mic_array
        self.c = c
        self.beamformer_type = "Base"

    def plot_setting(self):
        from ..plots.plots import _plt

        plt = _plt()
        fig, ax = plt.subplots(
            1, 1, figsize=(8, 5), subplot_kw={"projection": "3d"}
        )
        ax.scatter(
            self.mics.coordinates[:, 0],
            self.mics.coordinates[:, 1],
            self.mics.coordinates[:, 2],
        )
        if getattr(self, "grid", None) is not None:
            ax.scatter(
                self.grid.coordinates[:, 0],
                self.grid.coordinates[:, 1],
                self.grid.coordinates[:, 2],
            )
        ax.scatter(
            self.mics.array_center_coordinates[0],
            self.mics.array_center_coordinates[1],
            self.mics.array_center_coordinates[2],
            c="xkcd:dark green",
        )
        ax.set_xlabel("$x$ / m")
        ax.set_ylabel("$y$ / m")
        ax.set_zlabel("$z$ / m")
        ax.legend(["Mic Array", "Grid", "Center Mic"])
        return fig, ax

    def get_frequency_range_from_he(self, range_he=[4, 10]) -> list:
        assert len(range_he) == 2, "Range in He should have length two"
        return [self.mics.he_to_hz(i, self.c) for i in range_he]

    def show_info(self):
        txt = f"Beamformer: {self.beamformer_type}"
        txt = "\n" + txt + "\n" + "-" * len(txt) + "\n"
        txt += f"Aperture: {self.mics.aperture}\n"
        txt += f"Min mic distance: {self.mics.min_distance}\n"
        txt += (
            "Recommended f range: "
            f"{self.mics.get_maximum_frequency_range()}\n"
        )
        txt += f"Number of mics: {self.mics.number_of_points}\n"
        if getattr(self, "grid", None) is not None:
            txt += f"Number of grid points: {self.grid.number_of_points}\n"
        print(txt)


class BeamformerGridded(BaseBeamformer):
    """Beamformer with grid + steering vector
    (`beamforming.py:755-798`)."""

    def __init__(
        self,
        multi_channel_signal: Signal,
        mic_array: MicArray,
        grid: Grid,
        steering_vector: SteeringVector,
        c: float = 343,
    ):
        super().__init__(multi_channel_signal, mic_array, c)
        assert isinstance(steering_vector, SteeringVector), (
            "steering_vector should be of type SteeringVector"
        )
        assert issubclass(type(grid), Grid), "grid should be a Grid object"
        self.grid = grid
        self.st_vec = steering_vector

    def _finish_map(self, map_gf, f, clip_negative: bool):
        """Common map tail: optional negative clip, Simpson integration
        over the analysis band, grid reshape, `self.map` assignment.

        In lazy fp32 mode with a device-resident ``map_gf (G, F)`` the
        whole tail runs in one device program and the map is returned as
        a :class:`LazyHostArray`, so device consumers (tracking loops
        reading an argmax, map batches) skip the map fetch entirely.
        The Simpson rule is applied as its exact weight vector (linear in
        the data; weights extracted from `scipy.integrate.simpson` on
        identity rows, so host/device paths use identical quadrature)."""
        from .._config import lazy_host_returns

        lazy = (
            lazy_host_returns()
            and isinstance(map_gf, jnp.ndarray)
            and not isinstance(map_gf, np.ndarray)
        )
        n_f = len(f)
        if lazy:
            from ..classes.lazy_array import LazyHostArray
            from ..classes.signal import _dev_jit

            shape = self.grid.reconstruct_map_shape(
                np.zeros(self.grid.number_of_points)
            ).shape
            if n_f > 1:
                w = _simpson_uniform(
                    np.eye(n_f), dx=f[1] - f[0], axis=-1
                ).astype(np.float32)
            else:
                w = None

            def _post(m, wv=None):
                if clip_negative:
                    m = jnp.maximum(m, 0.0)
                v = m @ wv if wv is not None else m[:, 0]
                return v.reshape(shape)

            key = ("bf_map_post", bool(clip_negative), shape, n_f)
            out = (
                _dev_jit(key, _post)(map_gf, jnp.asarray(w))
                if w is not None
                else _dev_jit(key, _post)(map_gf)
            )
            self.map = LazyHostArray(out)
            return self.map.copy()
        map = np.array(map_gf)
        if clip_negative:
            map[map < 0] = 0
        if n_f > 1:
            map = _simpson_uniform(map, dx=f[1] - f[0], axis=1)
        else:
            map = map.squeeze()
        self.map = self.grid.reconstruct_map_shape(map)
        return self.map.copy()

    def _amp_diff_device(self):
        """Device-cached frequency-independent steering factors
        ``(amp (M, G), diff (M, G))`` — uploaded once per
        (steering-vector, formulation, grid, mics) combination instead of
        per map (reassigning any of them invalidates the cache)."""
        c = getattr(self, "_amp_diff_dev", None)
        if (
            c is None
            or c[0] is not self.st_vec
            or c[1] is not self.st_vec.formulation
            or c[2] is not self.grid
            or c[3] is not self.mics
        ):
            amp, diff = self.st_vec.get_amp_diff(self.grid, self.mics)
            # strong references keep the keys alive (plain id() keys could
            # alias a recycled address after garbage collection)
            c = (
                self.st_vec,
                self.st_vec.formulation,
                self.grid,
                self.mics,
                jnp.asarray(np.asarray(amp)),
                jnp.asarray(np.asarray(diff)),
            )
            self._amp_diff_dev = c
        return c[4], c[5]

    def _band_ids(self, center_frequency_hz, octave_fraction, f):
        """Analysis-band bin range ``(id1, id2)`` on the CSM frequency
        vector ``f``; also records center/fraction/f_range on self (shared
        by the host `_csm_slice` and the device-resident DAS path)."""
        self.center_frequency_hz = center_frequency_hz
        self.octave_fraction = octave_fraction
        self.f_range_hz = fractional_octave_bandwidth(
            center_frequency_hz, octave_fraction
        )
        ids = find_nearest_points_index_in_vector(self.f_range_hz, f)
        id1, id2 = int(ids[0]), int(ids[1])
        if id1 == id2:
            id2 += 1
        self.f_range_hz = np.array([f[id1], f[id2 - 1]])
        return id1, id2

    def _csm_slice(self, center_frequency_hz, octave_fraction):
        """Frequency vector + host CSM for the analysis band only."""
        # device-resident CSM: fetch only the ~15 analysis bins instead of
        # the full (F, C, C) matrix
        f, csm_re, csm_im = self.signal._get_csm_device()
        id1, id2 = self._band_ids(center_frequency_hz, octave_fraction, f)
        f = f[id1:id2]
        csm = np.asarray(csm_re[id1:id2]) + 1j * np.asarray(
            csm_im[id1:id2]
        )
        return f, csm

    def _csm_and_steering(self, center_frequency_hz, octave_fraction):
        f, csm = self._csm_slice(center_frequency_hz, octave_fraction)
        wave_numbers = f * np.pi * 2 / self.c
        h = self.st_vec.get_vector(
            wave_numbers, grid=self.grid, mic=self.mics
        )
        return f, csm, h


class BeamformerDASFrequency(BeamformerGridded):
    """Frequency-domain delay-and-sum (`beamforming.py:799-880`)."""

    beamformer_type = "Delay-and-sum (Frequency)"

    def get_beamformer_map(
        self,
        center_frequency_hz: float,
        octave_fraction: int = 3,
        remove_csm_diagonal: bool = True,
        mesh=None,
    ) -> np.ndarray:
        if mesh is not None and mesh.devices.size > 1:
            return self._get_beamformer_map_mesh(
                center_frequency_hz, octave_fraction, remove_csm_diagonal,
                mesh,
            )
        # zero-copy path: the CSM stays on the device; the analysis-band
        # slice, diagonal removal and quadratic form all run in one
        # program, so the band slice never round-trips through the host.
        f_all, csm_re_dev, csm_im_dev = self.signal._get_csm_device()
        id1, id2 = self._band_ids(
            center_frequency_hz, octave_fraction, f_all
        )
        f = f_all[id1:id2]
        wave_numbers = f * np.pi * 2 / self.c
        n_ch = self.signal.number_of_channels
        rm_diag = bool(remove_csm_diagonal)
        from .._config import run_jitted_complex

        # map[g, f] = h*_mg C_mn h_ng — packed-real quadratic forms
        # (`_das_map_core`). The steering tensor is built in-program
        # from its (M, G) factors (uploading the full (F, M, G) complex h
        # costs ~27 MB; amp/diff are ~1 MB and cached as device arrays
        # across maps)
        amp_dev, diff_dev = self._amp_diff_device()

        def _core(ampj, diffj, kj, cre_full, cim_full):
            cre = cre_full[id1:id2]
            cim = cim_full[id1:id2]
            if rm_diag:
                scale = n_ch / (n_ch - 1)
                off = 1.0 - jnp.eye(cre.shape[-1], dtype=cre.dtype)
                cre = cre * (scale * off)
                cim = cim * (scale * off)
            return _das_map_core(ampj, diffj, kj, cre, cim)

        map_gf = run_jitted_complex(
            _core,
            amp_dev,
            diff_dev,
            np.asarray(wave_numbers),
            csm_re_dev,
            csm_im_dev,
            materialize=False,  # lazy tail: the caller's fetch syncs
        )
        return self._finish_map(map_gf, f, bool(remove_csm_diagonal))

    def _get_beamformer_map_mesh(
        self, center_frequency_hz, octave_fraction, remove_csm_diagonal,
        mesh,
    ) -> np.ndarray:
        """Grid-parallel DAS over a device mesh
        (`parallel.ops.parallel_das_map`): grid points shard across the
        mesh's first axis, each device builds the steering block for its
        chunk in-program and evaluates its quadratic forms locally — the
        analysis-band CSM slice is replicated (a few hundred kB), so no
        collectives are needed. The grid is padded to a mesh-divisible
        count with unit-amplitude/zero-delay points and trimmed back."""
        f, csm = self._csm_slice(center_frequency_hz, octave_fraction)
        wave_numbers = f * np.pi * 2 / self.c
        if remove_csm_diagonal:
            n_ch = self.signal.number_of_channels
            off = 1.0 - np.eye(csm.shape[-1])
            csm = csm * (n_ch / (n_ch - 1) * off)
        amp, diff = self.st_vec.get_amp_diff(self.grid, self.mics)
        amp = np.asarray(amp)
        diff = np.asarray(diff)
        G = amp.shape[1]
        n = int(mesh.shape[mesh.axis_names[0]])
        pad = (-G) % n
        if pad:
            amp = np.concatenate(
                [amp, np.ones((amp.shape[0], pad), amp.dtype)], axis=1
            )
            diff = np.concatenate(
                [diff, np.zeros((diff.shape[0], pad), diff.dtype)], axis=1
            )
        from ..parallel.ops import parallel_das_map

        # np.array: device buffers come back read-only and the diagonal-
        # removal clip below writes in place
        map = np.array(
            parallel_das_map(amp, diff, wave_numbers, csm, mesh)
        )[:G]
        if remove_csm_diagonal:
            map[map < 0] = 0
        if len(f) > 1:
            map = _simpson_uniform(map, dx=f[1] - f[0], axis=1)
        else:
            map = map.squeeze()
        self.map = self.grid.reconstruct_map_shape(map)
        return self.map.copy()


class BeamformerCleanSC(BeamformerGridded):
    """CLEAN-SC deconvolution (Sijtsma 2007;
    `beamforming.py:883-1008`)."""

    beamformer_type = "CleanSC"

    def get_beamformer_map(
        self,
        center_frequency_hz: float,
        octave_fraction: int = 3,
        maximum_iterations: int | None = None,
        safety_factor: float = 0.5,
        remove_csm_diagonal: bool = False,
    ) -> np.ndarray:
        if maximum_iterations is None:
            maximum_iterations = self.signal.number_of_channels * 2
        else:
            assert maximum_iterations > 0, (
                "Number of iterations must be positive"
            )
        assert 0 < safety_factor <= 1, (
            f"{safety_factor} is not valid. The safety factor (loop gain) "
            "should be in ]0, 1]"
        )
        f, csm, h = self._csm_and_steering(
            center_frequency_hz, octave_fraction
        )
        if remove_csm_diagonal:
            eye = np.eye(csm.shape[-1], dtype=bool)
            csm[:, eye] = 0
        from .._config import clean_sc_on_device, run_jitted_complex

        if clean_sc_on_device():
            # ONE device program per map: initial packed-real quadratic
            # form + the full batched deconvolution loop (all bins)
            map = np.array(
                run_jitted_complex(
                    lambda hj, cj: _clean_sc_device_core(
                        _packed_quadratic_gf(
                            jnp.real(hj), jnp.imag(hj),
                            jnp.real(cj), jnp.imag(cj),
                        ),
                        cj,
                        hj,
                        int(maximum_iterations),
                        bool(remove_csm_diagonal),
                        float(safety_factor),
                    ),
                    h,
                    csm,
                    key=(
                        "clean_sc_full",
                        int(maximum_iterations),
                        bool(remove_csm_diagonal),
                        float(safety_factor),
                    ),
                )
            )
        else:
            h_H = np.swapaxes(h, 1, 2).conjugate()
            # host oracle path: per-bin Python loop (kept for parity
            # testing)
            map = np.array(
                run_jitted_complex(
                    lambda hj, cj: _packed_quadratic_gf(
                        jnp.real(hj), jnp.imag(hj),
                        jnp.real(cj), jnp.imag(cj),
                    ),
                    h,
                    csm,
                )
            )
            for find in range(len(f)):
                map[:, find] = clean_sc_deconvolve(
                    map[:, find],
                    csm[find],
                    h[find],
                    h_H[find],
                    maximum_iterations,
                    remove_csm_diagonal,
                    safety_factor,
                ).real
        if len(f) > 1:
            map = _simpson_uniform(map, dx=f[1] - f[0], axis=1)
        else:
            map = map.squeeze()
        self.map = self.grid.reconstruct_map_shape(map)
        return self.map.copy()


class BeamformerOrthogonal(BeamformerGridded):
    """Orthogonal beamforming (Sarradj 2010;
    `beamforming.py:1010-1125`)."""

    beamformer_type = "Orthogonal (Grid)"

    def get_beamformer_map(
        self,
        center_frequency_hz: float,
        octave_fraction: int = 3,
        number_eigenvalues: int | None = None,
    ) -> np.ndarray:
        if number_eigenvalues is None:
            number_eigenvalues = self.signal.number_of_channels // 2
        else:
            assert (
                number_eigenvalues <= self.signal.number_of_channels
            ), "Number of eigenvalues cannot be more than number of microphones"
            assert number_eigenvalues > 0, (
                "At least one eigenvalue of the CSM must be regarded"
            )
        f, csm, h = self._csm_and_steering(
            center_frequency_hz, octave_fraction
        )
        # batched eigendecomposition in f64 (ascending eigenvalues): the
        # source-subspace argmax below is sensitive to eigenvector
        # perturbations, so keep full precision here
        w, v = np.linalg.eigh(np.asarray(csm, dtype=np.complex128))
        E = int(number_eigenvalues)
        from .._config import run_jitted_complex

        def _ortho_core(hj, vj, wj):
            # products[f, g, e] = |h*_mg v_me|^2, e ascending from the
            # LARGEST eigenvalue (reference iterates -eig-1). Packed-real
            # block matmul (one 2M-contraction GEMM instead of 4 M-wide
            # complex-part GEMMs): (hre - i him)^T (vre + i vim) has
            # re = [hre|him]·[vre; vim], im = [hre|him]·[vim; -vre]
            hre, him = jnp.real(hj), jnp.imag(hj)
            vre, vim = jnp.real(vj), jnp.imag(vj)
            hp = jnp.concatenate(
                [jnp.swapaxes(hre, 1, 2), jnp.swapaxes(him, 1, 2)],
                axis=-1,
            )  # (F, G, 2M)
            v2 = jnp.concatenate(
                [
                    jnp.concatenate([vre, vim], axis=-1),
                    jnp.concatenate([vim, -vre], axis=-1),
                ],
                axis=-2,
            )  # (F, 2M, 2E)
            t = jnp.einsum("fgk,fke->fge", hp, v2, precision=_HIGH)
            n_e = vre.shape[-1]
            prod = t[..., :n_e] ** 2 + t[..., n_e:] ** 2
            sel = prod[:, :, -E:][..., ::-1]  # (F, G, E)
            wv = wj[:, -E:][:, ::-1]  # (F, E)
            idx = jnp.argmax(sel, axis=1)  # (F, E) source index per eig
            vals = (
                jnp.take_along_axis(sel, idx[:, None, :], axis=1)[:, 0, :]
                * wv
            )  # (F, E)
            # the reference OVERWRITES map[source_ind, f] per eig, so when
            # several eigenvalues pick the same grid point the last
            # (smallest considered eigenvalue) wins: emulate the
            # last-write-wins scatter with a per-cell max over writer ids
            gpts = sel.shape[1]
            onehot = idx[:, :, None] == jnp.arange(gpts)[None, None, :]
            e_ids = jnp.arange(E, dtype=jnp.int32)[None, :, None]
            e_last = jnp.max(
                jnp.where(onehot, e_ids, -1), axis=1
            )  # (F, G)
            val_at = jnp.take_along_axis(
                vals, jnp.clip(e_last, 0, None), axis=1
            )
            return jnp.where(e_last >= 0, val_at, 0.0).T  # (G, F)

        map = run_jitted_complex(
            _ortho_core,
            h,
            v,
            np.asarray(w, dtype=np.float32),
            materialize=False,
        )
        return self._finish_map(map, f, False)


class BeamformerFunctional(BeamformerGridded):
    """Functional beamforming (Dougherty 2014;
    `beamforming.py:1127-1221`)."""

    beamformer_type = "Functional"

    def get_beamformer_map(
        self,
        center_frequency_hz: float,
        octave_fraction: int = 3,
        gamma: float = 10,
    ) -> np.ndarray:
        f, csm, h = self._csm_and_steering(
            center_frequency_hz, octave_fraction
        )
        # batched matrix power via SVD (host f64 — eigenstructure of a
        # near-rank-deficient CSM is precision-sensitive)
        u, s, vh = np.linalg.svd(csm)
        s_pow = s ** (1 / gamma)
        csm_pow = np.einsum(
            "fmk,fk,fkn->fmn", u, s_pow, vh
        )
        from .._config import run_jitted_complex

        g_exp = float(gamma)

        def _func_core(hj, cj):
            hre, him = jnp.real(hj), jnp.imag(hj)
            num = _packed_quadratic_gf(
                hre, him, jnp.real(cj), jnp.imag(cj)
            )
            norm = jnp.einsum(
                "fmg,fmg->gf", hre, hre, precision=_HIGH
            ) + jnp.einsum("fmg,fmg->gf", him, him, precision=_HIGH)
            return (num / norm) ** g_exp * norm

        # complex operands go through the split-pair helper: an eager
        # complex upload cannot cross this backend's host boundary
        map = run_jitted_complex(
            _func_core, h, csm_pow, materialize=False
        )
        return self._finish_map(map, f, False)


class BeamformerMVDR(BeamformerGridded):
    """Minimum-variance distortionless response (Capon;
    `beamforming.py:1223-1315`)."""

    beamformer_type = "MVDR"

    def get_beamformer_map(
        self,
        center_frequency_hz: float,
        octave_fraction: int = 3,
        gamma: float = 10,
        solve_on_device: bool = True,
    ) -> np.ndarray:
        """MVDR map. The default path runs fully on the device: per-bin
        diagonal equilibration + diagonal loading + Cholesky + triangular
        solve + quadratic form in one jitted program (the CSM never
        visits the host).

        ``gamma`` is the diagonal-loading level in dB below each mic's
        auto-power: the solved matrix is ``C + 10^(-gamma/10)·diag(C)``
        (robust-Capon loading). The reference accepts ``gamma`` but never
        uses it and inverts the raw CSM in float64
        (`beamforming.py:1242,1299`) — measured Welch CSMs of coherent
        scenes are rank-deficient (cond ~1e9+), so that inverse is
        numerically arbitrary; the loaded solve is the well-posed form.
        ``solve_on_device=False`` reproduces the reference exactly
        (unloaded host f64 inverse + device quadratic form).
        """
        if solve_on_device:
            f, map = self._map_device_loaded(
                center_frequency_hz, octave_fraction, gamma
            )
            return self._finish_map(map, f, False)
        f, csm = self._csm_slice(center_frequency_hz, octave_fraction)
        wave_numbers = f * np.pi * 2 / self.c
        # Reference-exact path: invert host-side in f64 like the
        # reference (`beamforming.py:1290-1298`). The quadratic form
        # h^H C^-1 h is then safe on the device in fp32: C^-1 is Hermitian
        # PSD, so the form is a sum of POSITIVE eigen-contributions — no
        # cancellation, relative error stays at the fp32 floor — and it is
        # exactly the DAS kernel with C^-1 as the matrix (the steering
        # tensor is built in-program; host-side it cost ~14 MB + a zgemm
        # per map).
        csm_1 = np.linalg.inv(np.asarray(csm, dtype=np.complex128))
        amp_dev, diff_dev = self._amp_diff_device()
        from .._config import default_float, run_jitted_complex

        dt = default_float()
        denom = np.array(
            run_jitted_complex(
                _das_map_core,
                amp_dev,
                diff_dev,
                np.asarray(wave_numbers),
                np.ascontiguousarray(csm_1.real).astype(dt),
                np.ascontiguousarray(csm_1.imag).astype(dt),
            )
        )
        map = 1 / denom
        if len(f) > 1:
            map = _simpson_uniform(map, dx=f[1] - f[0], axis=1)
        else:
            map = map.squeeze()
        self.map = self.grid.reconstruct_map_shape(map)
        return self.map.copy()

    def _map_device_loaded(
        self,
        center_frequency_hz: float,
        octave_fraction: int,
        gamma: float,
    ):
        """Per-bin MVDR map ``(f, map (G, F))`` via the fully on-device
        loaded solve: with D = diag(C) and γ = 10^(-gamma/10), the solved
        system is C + γ·D, equilibrated as D^½(C̃ + γI)D^½ where C̃ has
        unit diagonal. The factorization is a batched LU with partial
        pivoting — NOT Cholesky: the reference CSM convention stores the
        element-wise *square root* of the cross-powers for amplitude
        scalings (`_spectral_methods.py:171-172`), which is Hermitian but
        indefinite (measured eigenvalues −12…+34 on the bench scene), so
        no PD factorization exists. Equilibration + loading keeps the
        fp32 solve within ~1e-5 of the f64 oracle on the loaded system.
        One jitted program; only the (G, F) real map crosses to the
        host."""
        from .._config import run_jitted_complex

        f_all, csm_re_dev, csm_im_dev = self.signal._get_csm_device()
        id1, id2 = self._band_ids(
            center_frequency_hz, octave_fraction, f_all
        )
        f = f_all[id1:id2]
        wave_numbers = np.asarray(f * np.pi * 2 / self.c)
        amp_dev, diff_dev = self._amp_diff_device()
        gamma_rel = float(10.0 ** (-gamma / 10.0))
        tiny = float(np.finfo(np.float32).tiny)

        def _mvdr_core(ampj, diffj, kj, cre_full, cim_full):
            C = cre_full[id1:id2] + 1j * cim_full[id1:id2]  # (F, M, M)
            d = jnp.real(jnp.diagonal(C, axis1=-2, axis2=-1))  # (F, M)
            s = jax.lax.rsqrt(jnp.maximum(d, tiny))
            # two-step scaling: s⊗s overflows fp32 when a bin has zero
            # energy (s ~ 1.8e19 → s² = inf → 0·inf = NaN); scaling C by
            # each factor separately stays finite (|C_ij| ≤ √(d_i d_j))
            Cn = (C * s[:, :, None]) * s[:, None, :]
            eye = jnp.eye(Cn.shape[-1], dtype=Cn.dtype)
            h = ampj[None, :, :] * jnp.exp(
                -1j * (kj[:, None, None] * diffj[None, :, :])
            )  # (F, M, G)
            hs = h * s[:, :, None]
            x = jnp.linalg.solve(Cn + gamma_rel * eye, hs)  # (F, M, G)
            # h^H (C+γD)^-1 h = (D^-½h)^H (C̃+γI)^-1 (D^-½h); real part as
            # the reference takes .real of the multi_dot
            denom = jnp.real(jnp.sum(jnp.conj(hs) * x, axis=1))  # (F, G)
            return (1.0 / denom).T  # (G, F)

        map = run_jitted_complex(
            _mvdr_core,
            amp_dev,
            diff_dev,
            wave_numbers,
            csm_re_dev,
            csm_im_dev,
            materialize=False,  # the caller's `_finish_map` keeps the
            # tail on device in lazy mode
        )
        return f, map


from functools import partial as _partial

# gather-buffer budget per DAS-time grid chunk (bytes)
_DAS_TIME_CHUNK_BYTES = 64e6


@_partial(jax.jit, static_argnames=("L",))
def _rfft_rows(x, L):
    """Batched rfft of the mic rows ``(M, T) → (M, F)`` with zero
    padding to ``L`` — one program shared by all grid chunks."""
    return jnp.fft.rfft(x, n=L, axis=-1)


def _delay_filter_response(h, s, L, cdtype):
    """rfft of the sparse fractional-delay FIRs: ``H[..., f] =
    e^{-2πi f s/L} · Σ_k h[..., k] e^{-2πi f k/L}`` — a (K, F) DFT
    matmul plus an elementwise phase ramp (no gathers)."""
    K = h.shape[-1]
    F = L // 2 + 1
    f = jnp.arange(F, dtype=jnp.float32)
    E = jnp.exp(
        (-2j * np.pi / L)
        * jnp.outer(jnp.arange(K, dtype=jnp.float32), f)
    ).astype(cdtype)  # (K, F)
    Hk = jnp.tensordot(
        h.astype(cdtype), E, axes=(-1, 0), precision=_HIGH
    )  # (..., F)
    phase = jnp.exp(
        (-2j * np.pi / L)
        * (s.astype(jnp.float32)[..., None] * f)
    ).astype(cdtype)
    return Hk * phase


@_partial(jax.jit, static_argnames=("L", "t_out"))
def _das_time_chunk(X, s, h, w, L, t_out):
    """Delay-and-sum over one grid chunk, frequency domain.

    ``y[g, t] = sum_m w[m, g] * (h[m, g] ∗ x_m)[t - s[m, g]]`` as one
    per-(mic, grid) response build + one einsum over mics + one batched
    inverse FFT. X (M, F) = rfft(x, L); s/w (M, G); h (M, G, K).
    """
    cdtype = X.dtype
    Hs = _delay_filter_response(h, s, L, cdtype)  # (M, G, F)
    Y = jnp.einsum(
        "mgf,mf->gf", w.astype(cdtype)[..., None] * Hs, X, precision=_HIGH
    )
    return jnp.fft.irfft(Y, n=L, axis=-1)[:, :t_out]


@_partial(jax.jit, static_argnames=("n_keep",))
def _das_time_finish(parts, n_keep):
    """Concatenate the grid chunks, drop the last chunk's padding and
    transpose to ``(T, G)`` — one program, no eager ops."""
    return jnp.concatenate(parts, axis=0)[:n_keep].T


@_partial(jax.jit, static_argnames=("L", "t_out"))
def _monopole_projection_kernel(x, s, h, amp, L, t_out):
    """``y[t, d] = amp[d] * (h[d] ∗ x)[t - s[d]]`` — one source signal
    delayed to D destinations via one rfft + response multiply + one
    batched irfft (replaces the per-tap gather form).
    x (T,); s/amp (D,); h (D, K)."""
    X = jnp.fft.rfft(x, n=L)
    Hs = _delay_filter_response(h, s, L, X.dtype)  # (D, F)
    y = jnp.fft.irfft(X[None, :] * Hs, n=L, axis=-1)[:, :t_out]
    return (y * amp[:, None]).T


class BeamformerDASTime(BaseBeamformer):
    """Time-domain delay-and-sum (`beamforming.py:1317-1395`)."""

    def __init__(
        self,
        multi_channel_signal: Signal,
        mic_array: MicArray,
        grid: Grid,
        c: float = 343,
    ):
        super().__init__(multi_channel_signal, mic_array, c)
        assert issubclass(type(grid), Grid), "grid should be a Grid object"
        self.grid = grid
        self.beamformer_type = "Delay-and-sum (Time)"

    def get_beamformer_output(self) -> Signal:
        """One batched Kaiser-sinc fractional-delay-and-sum program over
        (grid, mics) — replaces the reference's per-grid-point × per-mic
        `fractional_delay` loop (`beamforming.py:1317-1395`) with a gather
        + einsum kernel, chunked over grid points to bound the gather
        buffer. Numerically equivalent to applying the same pyfar-design
        fractional-delay FIR per channel."""
        from .._config import default_float
        from ..standard.backend import fractional_delay_filter_batch

        ds = self.mics.get_distances_to_point(self.grid.coordinates)
        if ds.ndim == 1:
            ds = ds[:, None]
        fs = self.signal.sampling_rate_hz
        min_distance = np.min(ds)
        r0 = np.max(ds)
        longest_delay = int((r0 - min_distance) / self.c * fs + 2)
        td = self.signal.time_data_jax  # (T, M)
        T = td.shape[0]
        total_length = T + longest_delay
        M, G = ds.shape

        dt = default_float()
        # geometry-keyed cache of the designed chunk tensors: repeated
        # maps over the same (mics, grid) skip the Kaiser-sinc design and
        # all per-chunk host->device uploads
        key = (
            hash(np.ascontiguousarray(ds).tobytes()),
            float(self.c), int(fs), int(T), np.dtype(dt).name,
        )
        cached = getattr(self, "_das_time_cache", None)
        if cached is None or cached[0] != key:
            from ..ops.fft_conv import next_fast_len

            s, h = fractional_delay_filter_batch(
                ((r0 - ds) / self.c * fs).ravel(), 30, 60
            )
            N = h.shape[1]
            s = s.reshape(M, G)
            h = h.reshape(M, G, N).astype(dt)
            # reference weighting: each delayed channel is scaled by its
            # distance, the sum divided by the mic count
            w = (ds / M).astype(dt)  # (M, G)
            L = int(
                next_fast_len(
                    total_length + int(max(0, s.max())) + N + 16,
                    real=True,
                )
            )

            # chunk the grid so the (M, Gc, F) response tensor stays
            # bounded (module constant so tests can force multi-chunk)
            bytes_per_point = M * (L // 2 + 1) * 8
            g_chunk = int(
                max(
                    1,
                    min(G, _DAS_TIME_CHUNK_BYTES // max(1, bytes_per_point)),
                )
            )
            n_chunks = -(-G // g_chunk)
            chunks = []
            for ci in range(n_chunks):
                lo, hi = ci * g_chunk, min(G, (ci + 1) * g_chunk)
                pad = g_chunk - (hi - lo)
                chunks.append((
                    jnp.asarray(
                        np.pad(s[:, lo:hi], ((0, 0), (0, pad)), mode="edge"),
                        jnp.int32,
                    ),
                    jnp.asarray(
                        np.pad(
                            h[:, lo:hi],
                            ((0, 0), (0, pad), (0, 0)),
                            mode="edge",
                        )
                    ),
                    jnp.asarray(
                        np.pad(w[:, lo:hi], ((0, 0), (0, pad)), mode="edge")
                    ),
                ))
            cached = (key, L, chunks)
            self._das_time_cache = cached
        _, L, chunks = cached

        X = _rfft_rows(td.T, L)  # (M, F), one batched program
        outs = [
            _das_time_chunk(X, s_c, h_c, w_c, L, total_length)
            for s_c, h_c, w_c in chunks
        ]
        out = _das_time_finish(outs, G)  # (total_length, G)

        base = pad_trim(self.signal.get_channels(0), total_length)
        return base.copy_with_new_time_data(out)


class MonopoleSource:
    """Omnidirectional point source (`beamforming.py:1397-1459`)."""

    def __init__(self, signal: Signal, coordinates):
        assert signal.number_of_channels == 1, (
            "Only signals with a single channel are supported"
        )
        coordinates = np.squeeze(coordinates)
        assert len(coordinates) == 3 and coordinates.ndim == 1, (
            "Coordinates should have exactly three values"
        )
        self.emitted_signal = signal
        self.coordinates = coordinates

    def get_signals_on_array(self, mics: MicArray, c: float = 343) -> Signal:
        """Project the source onto every mic with ONE batched Kaiser-sinc
        fractional-delay program (delay + 1/(1+r) spreading loss per mic)
        instead of the reference's per-mic `fractional_delay` + append loop
        (`beamforming.py:1397-1459`)."""
        from .._config import default_float
        from ..standard.backend import fractional_delay_filter_batch

        distances = mics.get_distances_to_point(self.coordinates)  # (M,)
        fs = self.emitted_signal.sampling_rate_hz
        if self.emitted_signal.is_complex_signal:
            warn(
                "Imaginary time data will be ignored in this function. "
                "Delay it manually by creating another signal object, if "
                "needed."
            )
        x = self.emitted_signal.time_data_jax[:, 0]  # (T,)
        T = x.shape[0]
        assert np.max(distances) / c * fs < T, (
            "Delay too large for the given signal"
        )
        dt = default_float()
        # geometry-keyed cache: repeated projections of the same source
        # onto the same array skip the filter design AND the three
        # host->device uploads
        key = (
            hash(np.ascontiguousarray(distances).tobytes()),
            float(c), int(fs), int(T), np.dtype(dt).name,
        )
        cached = getattr(self, "_projection_cache", None)
        if cached is None or cached[0] != key:
            from ..ops.fft_conv import next_fast_len

            s, h = fractional_delay_filter_batch(
                distances / c * fs, 30, 60
            )
            amp = (1.0 / (1.0 + distances)).astype(dt)  # (M,)
            N = h.shape[1]
            L = int(
                next_fast_len(
                    T + int(max(0, s.max())) + N + 16, real=True
                )
            )
            cached = (
                key,
                jnp.asarray(s, jnp.int32),
                jnp.asarray(h.astype(dt)),
                jnp.asarray(amp),
                L,
            )
            self._projection_cache = cached
        _, s_j, h_j, amp_j, L = cached
        out = _monopole_projection_kernel(x, s_j, h_j, amp_j, L, T)
        return self.emitted_signal.copy_with_new_time_data(out)


def mix_sources_on_array(sources, mics: MicArray, c: float = 343) -> Signal:
    """Combine several monopole sources on an array
    (`beamforming.py:1461-1513`)."""
    if isinstance(sources, MonopoleSource):
        sources = [sources]
    assert len(sources) > 0, (
        "There must be at least one source to project on array"
    )
    assert all(isinstance(i, MonopoleSource) for i in sources), (
        "All sources in list should be of type Source"
    )
    sources = list(sources)
    multi = sources[0].get_signals_on_array(mics, c)
    total_length = multi.time_data_jax.shape[0]
    sources.pop(0)
    for s in sources:
        if total_length != s.emitted_signal.time_data_jax.shape[0]:
            warn(
                "Emitted signals from sources differ in length. Trimming "
                "to shortest will be done"
            )
            total_length = min(
                total_length, s.emitted_signal.time_data_jax.shape[0]
            )
            multi = pad_trim(multi, total_length)
            s.emitted_signal = pad_trim(s.emitted_signal, total_length)
        ns = s.get_signals_on_array(mics, c)
        multi.time_data = multi.time_data + ns.time_data
    return multi


def _clean_sc_device_core(
    map0,  # (G, F) real initial map
    cj,  # (F, M, M) complex CSM (diagonal already removed if requested)
    hj,  # (F, M, G) complex steering
    maximum_iterations: int,
    remove_diagonal_csm: bool,
    safety_factor: float,
):
    """CLEAN-SC deconvolution for ALL frequency bins as one batched
    device loop (`/root/reference/dsptoolbox/beamforming/_beamforming.py:194-297`).

    The reference iterates bins on the host with a per-bin Python loop
    and a 20-step inner fixed point; here every bin advances in lockstep
    through a `lax.fori_loop` whose per-bin state carries an ``active``
    mask — a bin that hits the degenerate-CSM stopping rule
    (``||D_new||_1 >= ||D_old||_1``) keeps accumulating nothing while
    the rest continue, which is the device-friendly shape for
    data-dependent early exit (no dynamic trip counts inside the
    program). The entire map — initial quadratic form included — is ONE
    program launch."""
    import jax

    M = cj.shape[-1]
    eye = jnp.eye(M, dtype=map0.dtype)
    sf = jnp.asarray(safety_factor, map0.dtype)

    def one_bin(map0_g, C, h):
        def body(_, st):
            map_, second, D0, D1, active = st
            i = jnp.argmax(map_)
            p = map_[i]
            # the reference accumulates BEFORE its stopping check, so
            # the stop iteration still deposits its peak
            second = second.at[i].add(jnp.where(active, p * sf, 0.0))
            n1 = jnp.max(jnp.sum(jnp.abs(D1), axis=0))
            n0 = jnp.max(jnp.sum(jnp.abs(D0), axis=0))
            cont = active & (n1 < n0)
            w = h[:, i]
            wsq = jnp.conj(w) * w
            D_ = (D1 @ w) / p

            def fp(_, h_):
                H = jnp.conj(h_) * h_
                return (D_ + H * w) / jnp.sqrt(
                    1.0 + jnp.dot(H, wsq, precision=_HIGH)
                )

            h_ = jax.lax.fori_loop(0, 20, fp, w)
            G_ = jnp.outer(h_, jnp.conj(h_)) * p
            if remove_diagonal_csm:
                G_ = G_ * (1.0 - eye)
            corr = jnp.real(
                jnp.einsum(
                    "mg,mn,ng->g", jnp.conj(h), G_, h, precision=_HIGH
                )
            )
            map_new = jnp.where(cont, map_ - corr * sf, map_)
            D0n = jnp.where(cont, D1, D0)
            D1n = jnp.where(cont, D1 - sf * G_, D1)
            return map_new, second, D0n, D1n, cont

        st0 = (
            map0_g,
            jnp.zeros_like(map0_g),
            C * 2.0,
            C,
            jnp.asarray(True),
        )
        out = jax.lax.fori_loop(0, maximum_iterations, body, st0)
        return out[1]

    # vmap over frequency bins: every bin is an independent deconvolution
    return jnp.swapaxes(
        jax.vmap(one_bin)(jnp.swapaxes(map0, 0, 1), cj, hj), 0, 1
    )


def clean_sc_deconvolve(
    map: np.ndarray,
    csm: np.ndarray,
    h: np.ndarray,
    h_H: np.ndarray,
    maximum_iterations: int,
    remove_diagonal_csm: bool,
    safety_factor: float,
) -> np.ndarray:
    """CLEAN-SC inner loop (`_beamforming.py:194-297`); quadratic forms per
    iteration run as device einsums."""
    D = np.append(csm[None, ...] * 2, csm[None, ...], axis=0)
    second_map = np.zeros_like(map)
    for _ in range(maximum_iterations):
        maximum_power_ind = int(np.argmax(map))
        maximum_power = map[maximum_power_ind]
        second_map[maximum_power_ind] += maximum_power * safety_factor
        if np.linalg.norm(D[1], ord=1) >= np.linalg.norm(D[0], ord=1):
            break
        w_max = h[:, maximum_power_ind]
        h_ = w_max.copy()
        w_max_squared = w_max.conjugate() * w_max
        D_ = D[1] @ w_max / maximum_power
        for _ in range(20):
            H = h_.conjugate() * h_
            h_ = (D_ + H * w_max) / np.sqrt(1 + H @ w_max_squared)
        G = np.outer(h_, h_.conjugate()) * maximum_power
        if remove_diagonal_csm:
            np.fill_diagonal(G, 0)
        # host BLAS: the per-iteration matrices are tiny, and device
        # dispatch would re-upload the loop-invariant steering tensors
        # every iteration
        correction = np.einsum(
            "gm,mg->g", h_H @ G, h
        ).real
        map -= correction * safety_factor
        temp = D[1].copy()
        D[1] = D[1] - safety_factor * G
        D[0] = temp
    return second_map
